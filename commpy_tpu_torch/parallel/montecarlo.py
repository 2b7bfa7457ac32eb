"""Monte-Carlo BER engine, on one device or data-parallel over a mesh.

Counterpart of ``commpy_tpu/parallel/montecarlo.py``.  The reference's
serial ``while bit_send < send_max and bit_err < err_min`` loop
(links.py:313-338) becomes rounds: each round simulates
``frames_per_round`` frames at every still-active SNR point, and the host
only takes the stopping decision between rounds.  While ``montecarlo_ber``
calls its ``round_fn`` it publishes its mask of active points in a context
variable, which reaches the round through any ``(seed, rnd)`` wrapper: the
round builds generators for, simulates and tallies only those points, and
reads 0 at the others.  A round called outside a sweep simulates every
point.

Randomness: the frames of round r at SNR index i are drawn from a
``torch.Generator`` on the device seeded from (seed, r, i), so a resumed
sweep repeats exactly the rounds it would have run.  With a mesh of D
ranks each rank draws the round's F frames from that same generator and
simulates rows ``[r*F/D, (r+1)*F/D)`` of them (``link_step(..., rows=)``),
and the tallies are summed over the ranks (one all-reduce a round): a
round's tallies do not depend on the mesh, and every rank takes the same
stopping decision.  The draw is repeated on every rank; it costs little
next to a decode.

Under a profiler the engine's host work is named on the timeline
(``utils.profiling.span``): ``mc.sweep`` around ``montecarlo_ber``,
``mc.round`` around a round, and inside it ``mc.seed`` (the round's
generators) and ``mc.tally`` (the tallies' stack, the all-reduce with a
mesh, and their read-back: the round's one sync).
"""
from __future__ import annotations

import contextvars
import json
import logging
import os
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.profiling import span
from .mesh import DeviceMesh, axis_index, axis_size, check_axis, psum

__all__ = ["MonteCarloResult", "montecarlo_ber", "make_round_fn"]

logger = logging.getLogger("commpy_tpu_torch.montecarlo")

# the running sweep's active points ([n_snr] bool), None outside a sweep
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "commpy_tpu_torch.montecarlo.active", default=None)


@dataclass
class MonteCarloResult:
    snrs_db: np.ndarray
    bers: np.ndarray
    bit_errors: np.ndarray
    bits_sent: np.ndarray
    rounds: int


def _round_generator(seed: int, rnd: int, snr_index: int,
                     device) -> torch.Generator:
    """The generator of round ``rnd`` at SNR index ``snr_index``."""
    state = np.random.SeedSequence([seed, rnd, snr_index]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) & ((1 << 63) - 1))
    return gen


def make_round_fn(link_step: Callable, noise_stds: Sequence[float],
                  frames_per_round: int, device="cuda",
                  mesh: Optional[DeviceMesh] = None, axis_name: str = "dp"):
    """Build ``round_fn(seed, rnd) -> bit errors [n_snr]`` (NumPy int64).

    ``link_step(generator, n_frames, noise_std) -> bit errors`` (a scalar
    tensor).  All SNR points of a round are queued on the device and read
    back with one synchronisation.  Called by :func:`montecarlo_ber`
    (directly or through a wrapper), the round simulates only the points
    that the sweep still counts, each from its own generator, and reads 0
    at the points that have stopped; called outside a sweep, it simulates
    every point.

    With a ``mesh`` (this rank's, the frame axis split over its
    ``axis_name``), ``link_step`` must also take ``rows``, a slice of the
    frames: it draws all ``n_frames`` and simulates and counts only those
    rows (as every :class:`~commpy_tpu_torch.models.DeviceLink` does); the
    counts are summed over the ranks.
    """
    dev = resolve_device(device)
    noise_stds = [float(np.float32(ns)) for ns in noise_stds]
    rows = None
    if mesh is not None:
        check_axis(mesh, axis_name)
        n_dev = axis_size(mesh)
        if frames_per_round % n_dev:
            raise ValueError(
                f"frames_per_round ({frames_per_round}) must be a multiple "
                f"of the mesh size ({n_dev})")
        per = frames_per_round // n_dev
        r = axis_index(mesh)
        rows = slice(r * per, (r + 1) * per)

    def round_fn(seed: int, rnd: int) -> np.ndarray:
        n_snr = len(noise_stds)
        active = _ACTIVE.get()
        if active is None:
            points = list(range(n_snr))
        elif active.shape != (n_snr,):
            raise ValueError(
                f"the sweep's mask of active points has shape "
                f"{active.shape}; this round_fn has {n_snr} SNR points")
        else:
            points = np.flatnonzero(active).tolist()
        out = np.zeros(n_snr, np.int64)
        with span("mc.round"):
            with span("mc.seed"):
                gens = [_round_generator(seed, rnd, i, dev) for i in points]
            shard = {} if rows is None else {"rows": rows}
            errs = [link_step(g, frames_per_round, noise_stds[i], **shard)
                    for g, i in zip(gens, points)]
            with span("mc.tally"):
                errs = torch.stack(errs)
                if rows is not None:
                    # every rank holds the same mask: the all-reduces match
                    errs = psum(errs.to(torch.int64), mesh)
                out[points] = errs.cpu().numpy()
                return out

    round_fn.frames_per_round = frames_per_round
    round_fn.noise_stds = np.asarray(noise_stds)
    return round_fn


def montecarlo_ber(
    link_step: Callable,
    snrs_db,
    noise_std_fn: Callable,
    frame_bits: int,
    seed: int = 0,
    *,
    frames_per_round: int,
    max_rounds: int = 100,
    err_min: int = 100,
    send_max: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    round_fn: Optional[Callable] = None,
    device="cuda",
    mesh: Optional[DeviceMesh] = None,
    axis_name: str = "dp",
) -> MonteCarloResult:
    """Run the BER sweep with err_min / send_max early stopping.

    An SNR point stops accumulating once it has ``err_min`` bit errors or
    ``send_max`` sent bits; finished points are frozen and no longer
    simulated (reference links.py:309-341, at round granularity).

    Parameters
    ----------
    link_step : ``(generator, n_frames, noise_std) -> bit errors``
    noise_std_fn : ``snr_db -> noise_std`` (see ops.channel.snr_to_noise_std)
    frame_bits : message bits per frame (for BER normalisation)
    seed : integer seed of the sweep's generators
    checkpoint_path : optional JSON file; tallies and the round counter are
        written after every round and the sweep resumes from the file if it
        exists.  With a mesh, rank 0 reads and writes it and hands what it
        read to the other ranks.
    round_fn : optional prebuilt :func:`make_round_fn` result for this
        configuration, or a ``(seed, rnd)`` wrapper that calls one; the
        sweep's mask of active points reaches it through the wrapper.
    device : where the frames are simulated (default ``"cuda"``).
    mesh, axis_name : split each round's frames over the ranks of
        ``mesh`` (see :func:`make_round_fn`); every rank calls the sweep
        and returns the same result.
    """
    with span("mc.sweep"):
        snrs_db = np.atleast_1d(np.asarray(snrs_db, float))
        noise_stds = np.asarray([float(noise_std_fn(s)) for s in snrs_db])
        if round_fn is None:
            round_fn = make_round_fn(link_step, noise_stds, frames_per_round,
                                     device, mesh, axis_name)
        else:
            fpr = getattr(round_fn, "frames_per_round", None)
            if fpr is not None and fpr != frames_per_round:
                raise ValueError(
                    f"round_fn was built with frames_per_round={fpr}, sweep "
                    f"requested {frames_per_round}")
            ns = getattr(round_fn, "noise_stds", None)
            if ns is not None and not np.allclose(ns, noise_stds):
                raise ValueError(
                    "round_fn was built with different noise_stds than this "
                    "sweep's snrs_db/noise_std_fn produce")

        n_snr = len(snrs_db)
        bits_per_round = frames_per_round * frame_bits
        if send_max is None:
            send_max = bits_per_round * max_rounds

        tot_err = np.zeros(n_snr)
        tot_bits = np.zeros(n_snr)
        active = np.ones(n_snr, bool)
        start_round = 0
        writer = mesh is None or axis_index(mesh) == 0
        st = None
        if checkpoint_path and writer and os.path.exists(checkpoint_path):
            with open(checkpoint_path) as f:
                st = json.load(f)
        if checkpoint_path and mesh is not None:
            box = [st]
            group = mesh.get_group()
            dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                                       group=group)
            st = box[0]
        if st is not None:
            if st["snrs_db"] == list(map(float, snrs_db)):
                tot_err = np.asarray(st["bit_errors"], float)
                tot_bits = np.asarray(st["bits_sent"], float)
                # activity is recomputed against THIS run's limits
                active = (tot_err < err_min) & (tot_bits < send_max)
                start_round = int(st["round"])
                logger.info("resumed sweep from %s at round %d",
                            checkpoint_path, start_round)

        rounds = start_round
        for r in range(start_round, max_rounds):
            if not active.any():
                break
            token = _ACTIVE.set(active.copy())
            try:
                errs = round_fn(seed, r)
            finally:
                _ACTIVE.reset(token)
            tot_err[active] += errs[active]
            tot_bits[active] += bits_per_round
            rounds = r + 1
            active &= (tot_err < err_min) & (tot_bits < send_max)
            if checkpoint_path and writer:
                tmp = checkpoint_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({
                        "snrs_db": list(map(float, snrs_db)),
                        "bit_errors": tot_err.tolist(),
                        "bits_sent": tot_bits.tolist(),
                        "active": active.tolist(),
                        "round": rounds,
                    }, f)
                os.replace(tmp, checkpoint_path)

        with np.errstate(invalid="ignore"):
            bers = np.where(tot_bits > 0,
                            tot_err / np.maximum(tot_bits, 1), 0.0)
        return MonteCarloResult(snrs_db, bers, tot_err, tot_bits, rounds)
