"""Reference-compatible links module (commpy.links API).

Counterpart of ``commpy_tpu/links.py``.  ``LinkModel`` keeps the
reference's duck-typed surface (links.py:67-343), so any modulate /
receive / decoder combination plugs in unchanged.  ``link_performance``
and ``link_performance_full_metrics`` keep the reference's host loops
(chunk rounding, signature-sniffed decoders, err_min early stopping);
each chunk computes where its callables and the channel object compute
(the port's modems, channels and decoders on ``device``).
``link_performance_device`` runs the sweep through the port's
Monte-Carlo engine with every frame on the device.
"""
from __future__ import annotations

import math
from fractions import Fraction
from inspect import getfullargspec

import numpy as np
import torch

from .channels import MIMOFlatChannel
from .utils.device import resolve_device

__all__ = ["link_performance", "LinkModel", "idd_decoder"]


def link_performance(link_model, SNRs, send_max, err_min, send_chunk=None,
                     code_rate=1):
    """Module-level wrapper (reference links.py:29-64)."""
    if not send_chunk:
        send_chunk = err_min
    return link_model.link_performance(
        SNRs, send_max, err_min, send_chunk, code_rate
    )


class LinkModel:
    """Link model (reference links.py:67-343).  ``device`` (keyword-only,
    default ``"cuda"``) is where :meth:`link_performance_device` simulates
    its frames."""

    def __init__(self, modulate, channel, receive, num_bits_symbol,
                 constellation, Es=1, decoder=None, rate=Fraction(1, 1), *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.modulate = modulate
        self.channel = channel
        self.receive = receive
        self.num_bits_symbol = num_bits_symbol
        self.constellation = constellation
        self.Es = Es
        if type(rate) is float:
            rate = Fraction(rate).limit_denominator(100)
        self.rate = rate
        self.decoder = decoder if decoder is not None else (lambda msg: msg)
        self.full_simulation_results = None

    # -- shared helpers ---------------------------------------------------

    def _round_chunk(self, send_chunk, err_min, code_rate):
        if send_chunk is None:
            send_chunk = err_min
        if type(code_rate) is float:
            code_rate = Fraction(code_rate).limit_denominator(100)
        self.rate = code_rate
        divider = (
            Fraction(1, self.num_bits_symbol * self.channel.nb_tx)
            * 1 / code_rate
        ).denominator
        return max(divider, send_chunk // divider * divider), code_rate

    def _transmit(self, msg, full_args_decoder):
        """One chunk through modulate -> channel -> receive -> decode."""
        symbs = self.modulate(msg)
        channel_output = self.channel.propagate(symbs)
        receive_size = self.channel.nb_tx * self.num_bits_symbol

        if isinstance(self.channel, MIMOFlatChannel):
            nb_symb_vector = len(channel_output)
            received_msg = np.empty(
                int(math.ceil(len(msg) / float(self.rate)))
            )
            for i in range(nb_symb_vector):
                received_msg[receive_size * i : receive_size * (i + 1)] = (
                    self.receive(
                        channel_output[i],
                        self.channel.channel_gains[i],
                        self.constellation,
                        self.channel.noise_std ** 2,
                    )
                )
        else:
            received_msg = self.receive(
                channel_output,
                self.channel.channel_gains,
                self.constellation,
                self.channel.noise_std ** 2,
            )

        if full_args_decoder:
            decoded_bits = self.decoder(
                channel_output,
                self.channel.channel_gains,
                self.constellation,
                self.channel.noise_std ** 2,
                received_msg,
                self.channel.nb_tx * self.num_bits_symbol,
            )
        else:
            decoded_bits = self.decoder(received_msg)
        return decoded_bits

    # -- public sweeps ----------------------------------------------------

    def link_performance_full_metrics(
        self, SNRs, tx_max, err_min, send_chunk=None,
        code_rate: Fraction = Fraction(1, 1), number_chunks_per_send=1,
        stop_on_surpass_error=True,
    ):
        """Per-transmission BER/BE/CE/NC tallies (links.py:155-267)."""
        SNRs = np.asarray(SNRs, dtype=float)
        BERs = np.zeros_like(SNRs, dtype=float)
        BEs = np.zeros((len(SNRs), tx_max), dtype=int)
        CEs = np.zeros((len(SNRs), tx_max), dtype=int)
        NCs = np.zeros((len(SNRs), tx_max), dtype=int)

        send_chunk, code_rate = self._round_chunk(
            send_chunk, err_min, code_rate
        )
        full_args_decoder = len(getfullargspec(self.decoder).args) > 1

        for id_SNR in range(len(SNRs)):
            self.channel.set_SNR_dB(SNRs[id_SNR], float(code_rate), self.Es)
            total_tx_send = 0
            bit_err = np.zeros(tx_max, dtype=int)
            chunk_loss = np.zeros(tx_max, dtype=int)
            chunk_count = np.zeros(tx_max, dtype=int)
            for id_tx in range(tx_max):
                if stop_on_surpass_error and bit_err.sum() > err_min:
                    break
                msg = np.random.choice(
                    (0, 1), send_chunk * number_chunks_per_send
                )
                decoded_bits = self._transmit(msg, full_args_decoder)
                for i in range(number_chunks_per_send):
                    errors = np.bitwise_xor(
                        msg[send_chunk * i : send_chunk * (i + 1)],
                        decoded_bits[
                            send_chunk * i : send_chunk * (i + 1)
                        ].astype(int),
                    ).sum()
                    bit_err[id_tx] += errors
                    chunk_loss[id_tx] += 1 if errors > 0 else 0
                chunk_count[id_tx] += number_chunks_per_send
                total_tx_send += 1
            BERs[id_SNR] = bit_err.sum() / (total_tx_send * send_chunk)
            BEs[id_SNR] = bit_err
            CEs[id_SNR] = np.where(bit_err > 0, 1, 0)
            NCs[id_SNR] = chunk_count
            if BEs[id_SNR].sum() < err_min:
                break
        self.full_simulation_results = BERs, BEs, CEs, NCs
        return BERs, BEs, CEs, NCs

    def link_performance_device(self, SNRs, send_max, err_min,
                                send_chunk=None, code_rate=1, *,
                                frames_per_round=32, mesh=None, seed=0):
        """``link_performance`` through the port's Monte-Carlo engine.

        Each frame is one ``send_chunk``.  ``modulate``, ``receive`` and
        ``decoder`` must take and return tensors on ``device`` (for
        example the port's device functions); a MIMO ``receive`` takes
        one vector and is mapped over a frame's vectors with
        ``torch.func.vmap``.  The frames of a round run one after another
        on the device, each through the user's callables (a decoder
        launching a CUDA kernel cannot be vmapped), and their errors are
        summed there: the host syncs once a round.

        The channel object's stateful ``propagate`` is not used: its
        calibration and fading parameters drive
        :mod:`commpy_tpu_torch.ops.channel` (``SISOFlatChannel`` and
        ``MIMOFlatChannel`` with any Kronecker fading), so the SNR
        calibration matches the host loop.  The full-args (IDD) decoder
        signature is honoured as in ``_transmit``.  Statistics match the
        host loop at round granularity (err_min / send_max early stopping
        per SNR).  With ``mesh`` (every rank calls this), each round's
        frames are drawn whole on every rank and split over the ranks
        (``parallel.montecarlo``): the BERs equal ``mesh=None``'s for the
        same seed.
        """
        from .ops import channel as _chk
        from .parallel.montecarlo import montecarlo_ber

        dev = self.device
        SNRs = np.asarray(SNRs, dtype=float)
        send_chunk, code_rate = self._round_chunk(
            send_chunk, err_min, code_rate
        )
        full_args_decoder = len(getfullargspec(self.decoder).args) > 1
        ch = self.channel
        is_mimo = isinstance(ch, MIMOFlatChannel)
        const = np.asarray(self.constellation)
        nbs = self.num_bits_symbol
        if is_mimo:
            mean, srt, srr = _chk.kronecker_sqrt_factors(ch.fading_param)

        def link_step(generator, n_frames, noise_std, rows=None):
            msgs = torch.randint(0, 2, (n_frames, send_chunk),
                                 generator=generator, device=dev,
                                 dtype=torch.int8)
            symbs = torch.stack([self.modulate(m) for m in msgs])
            nv = float(noise_std) ** 2
            mine = range(n_frames)[rows or slice(None)]
            if is_mimo:
                y, h, _ = _chk.mimo_propagate(
                    generator, symbs.reshape(n_frames, -1, ch.nb_tx),
                    noise_std, mean, srt, srr, ch.isComplex, dev)
                rx = torch.func.vmap(torch.func.vmap(
                    lambda yy, hh: self.receive(yy, hh, const, nv)))(y, h)
                rx = rx.reshape(n_frames, -1)
            else:
                y, h, _ = _chk.siso_propagate(
                    generator, symbs, noise_std, ch.fading_param,
                    ch.isComplex, dev)
                rx = {f: self.receive(y[f], h[f], const, nv) for f in mine}
            errs = torch.zeros((), dtype=torch.int32, device=dev)
            for f in mine:
                if full_args_decoder:
                    dec = self.decoder(y[f], h[f], const, nv, rx[f],
                                       ch.nb_tx * nbs)
                else:
                    dec = self.decoder(rx[f])
                dec = torch.as_tensor(dec, device=dev)[:send_chunk]
                errs = errs + torch.sum(dec.to(torch.int32)
                                        != msgs[f].to(torch.int32),
                                        dtype=torch.int32)
            return errs

        def noise_std_fn(snr_db):
            ch.set_SNR_dB(float(snr_db), float(code_rate), self.Es)
            return float(ch.noise_std)

        max_rounds = max(1, -(-int(send_max) //
                              (send_chunk * frames_per_round)))
        res = montecarlo_ber(
            link_step, SNRs, noise_std_fn, send_chunk, seed=seed,
            frames_per_round=frames_per_round, max_rounds=max_rounds,
            err_min=err_min, device=dev, mesh=mesh,
            axis_name=None if mesh is None else mesh.mesh_dim_names[0],
        )
        return res.bers

    def link_performance(self, SNRs, send_max, err_min, send_chunk=None,
                         code_rate=1):
        """BER Monte-Carlo sweep (links.py:269-343)."""
        SNRs = np.asarray(SNRs, dtype=float)
        BERs = np.zeros_like(SNRs, dtype=float)
        send_chunk, code_rate = self._round_chunk(
            send_chunk, err_min, code_rate
        )
        full_args_decoder = len(getfullargspec(self.decoder).args) > 1

        for id_SNR in range(len(SNRs)):
            self.channel.set_SNR_dB(SNRs[id_SNR], float(code_rate), self.Es)
            bit_send = 0
            bit_err = 0
            while bit_send < send_max and bit_err < err_min:
                msg = np.random.choice((0, 1), send_chunk)
                decoded_bits = self._transmit(msg, full_args_decoder)
                bit_err += np.bitwise_xor(
                    msg, decoded_bits[: len(msg)].astype(int)
                ).sum()
                bit_send += send_chunk
            BERs[id_SNR] = bit_err / bit_send
            if bit_err < err_min:
                break
        return BERs


def idd_decoder(detector, decoder, decision, n_it):
    """Iterative detection-and-decoding closure (links.py:345-407).

    The loop itself is host orchestration; it computes where
    ``detector``, ``decoder`` and ``decision`` compute (the batched device
    form is :func:`commpy_tpu_torch.models.idd.idd_decoder_device`).
    """

    def decode(y, h, constellation, noise_var, a_priori, bits_per_send):
        a_priori_decoder = a_priori.copy()
        nb_vect, nb_rx, nb_tx = h.shape
        for _ in range(n_it):
            a_priori_detector = decoder(a_priori_decoder) - a_priori_decoder
            for i in range(nb_vect):
                a_priori_decoder[
                    i * bits_per_send : (i + 1) * bits_per_send
                ] = detector(
                    y[i],
                    h[i],
                    constellation,
                    noise_var,
                    a_priori_detector[
                        i * bits_per_send : (i + 1) * bits_per_send
                    ],
                )
            a_priori_decoder -= a_priori_detector
        return decision(a_priori_decoder + a_priori_detector)

    return decode
