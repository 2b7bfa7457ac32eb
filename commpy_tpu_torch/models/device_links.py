"""Batched end-to-end link pipelines.

Counterpart of ``commpy_tpu/models/device_links.py``.  Each factory
returns a :class:`DeviceLink` whose ``link_step(generator, n_frames,
noise_std) -> bit_errors`` simulates a batch of frames on one device:
random bits -> FEC encode -> map -> channel -> demap / detect -> decode ->
XOR count.  The random draws and the deterministic chain are separate:
``transceive(bits, noise, noise_std, *channel)`` takes the bits, the unit
complex noise and the channel draws as inputs, so tests can feed the JAX
package and the port the same draws; it is ``decode(receive(...))``,
where ``receive`` ends with the decoder's input.  Each stage runs under a
:func:`~commpy_tpu_torch.utils.profiling.span` named ``link.<stage>``
(``link.draw`` for the random draws of ``link_step``), so a profile
assigns device time by stage; with no profiler recording a span costs
next to nothing.

Conventions follow the reference link stack: SNR_dB = (Eb/N0)_dB +
10 log10(Rc * Mc); complex AWGN noise ``(re + 1j*im) * noise_std * 0.5``;
soft Viterbi consumes LLRs with positive => bit 1; LDPC BP consumes
``llr = -demodulate_soft(...)``, positive => bit 0 (signbit decisions).
The turbo link is real BPSK over real AWGN, ``tx + noise * noise_std``;
the LTE turbo link (:func:`make_lte_turbo_link`, outside ``__all__``: the
JAX package has no such link) is 16-QAM over complex AWGN, and its
decoder takes half the exact LLRs.
The MIMO detectors' LLRs follow the reference's sign (positive => bit 0).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import modem as M
from ..ops import ofdm as OFDM
from ..ops import polar as P
from ..ops.bch import (bch_construct, make_bch_chase_decoder,
                       make_bch_decoder, make_bch_encoder)
from ..ops.channel import crandn, snr_to_noise_std
from ..ops.convcode import depuncture_device, encode_scan, puncture_mask
from ..ops.dvbs2 import dvbs2_decode_device, dvbs2_encode_device
from ..ops.equalize import (_conv_matrix, equalize, equalizer_delay,
                            mmse_fir_taps)
from ..ops.filters import rrcosfilter
from ..ops.fir import fir_filter, upfirdn
from ..ops.impairments import add_frequency_offset
from ..ops.ldpc import build_matrix, ldpc_bp_decode_device, ldpc_encode_device
from ..ops.mimo import best_first_device, kbest_device
from ..ops.qcldpc import qc_bp_decode_device, qc_encoder
from ..ops.rs import (_bits_to_sym, _sym_to_bits, make_rs_decoder,
                      make_rs_encoder, make_rs_gmd_decoder)
from ..ops.scramble import descramble, scramble
from ..ops.sync import cfo_correct, cfo_estimate_cp
from ..ops.trellis import Trellis
from ..ops.interleave import qpp_interleaver
from ..ops.turbo import (lte_trellis, tail_streams, turbo_decode_device,
                         turbo_encode_device)
from ..ops.viterbi import viterbi_decode_device
from ..utils.device import device_constant, on_device, resolve_device
from ..utils.linalg import small_matmul
from ..utils.profiling import span
from .idd import idd_decoder_device

__all__ = ["DeviceLink", "make_conv_awgn_link", "make_rrc_conv_awgn_link",
           "make_turbo_awgn_link", "make_qcldpc_awgn_link",
           "make_ofdm_qcldpc_link", "make_dvbs2_concat_link",
           "make_isi_conv_link", "make_bch_awgn_link", "make_rs_awgn_link",
           "make_ldpc_rayleigh_link", "make_kbest_mimo_link",
           "make_bestfirst_ldpc_mimo_link", "make_ofdm_mimo_conv_link",
           "make_polar_awgn_link", "make_idd_kbest_ldpc_mimo_link"]


@dataclass
class DeviceLink:
    """A batched link simulation on one device.

    link_step : ``(generator, n_frames, noise_std, rows=None) -> bit
        errors`` (int32 scalar tensor on ``device``): ``draw``, then
        ``transceive`` and the count.  With ``rows`` (a slice of the
        ``n_frames``), every frame is drawn and only those rows are
        simulated and counted, so the shards of a round add up to the
        round exactly (the data-parallel engine's split).
    transceive : ``(bits [F, frame_bits] int8, noise [F, n_symbols]
        complex64, noise_std, *channel) -> decoded bits [F, frame_bits]
        int8``; the deterministic part of ``link_step``.  ``noise`` holds
        unit complex normals, scaled by ``noise_std * 0.5`` inside.  The
        turbo link's noise is real: ``[F, frame_bits, 3]`` float32
        (systematic and two parity streams), and ``n_symbols`` counts its
        values.  The channel draws, a fourth argument, by link:

        ======================  ==========================  ================
        link                    noise                       channel
        ======================  ==========================  ================
        LDPC Rayleigh           ``[F, n_symbols]``          ``h [F,
                                                            n_symbols]``
        K-best / best-first /   ``[F, n_vec, nr]``          ``h [F, n_vec,
        IDD MIMO                                            nr, nt]``
        OFDM-MIMO conv          time domain ``[F, nr, T]``  ``h [F, nr,
                                                            nt]``
        OFDM-LDPC               time domain ``[F, T]``      taps ``g [F,
                                                            n_taps]``
        ======================  ==========================  ================

        All complex64, each the channel itself (the link's ``link_step``
        draws unit normals and scales them); the OFDM-LDPC link's CFO is a
        constant of the link.  For the LDPC, MIMO and OFDM links,
        ``extras["noise_shape"]`` and ``extras["channel_shape"]`` (None
        without a channel) give the shapes after the frame axis and
        ``extras["channel_scale"]`` the scale ``link_step`` gives its unit
        channel draw.
    receive : same arguments as ``transceive``; returns the decoder's
        input (depunctured LLRs, hard bits or reals) ``[F, n_coded]``; the
        turbo link's is the received reals ``[F, frame_bits, 3]``; the
        uncoded K-best link's the detected symbols ``[F, n_vec * nt]``;
        the IDD link's the tuple the loop starts from (see
        :func:`make_idd_kbest_ldpc_mimo_link`).
    decode : ``receive``'s output -> decoded bits ``[F, frame_bits]``; the
        turbo link's also takes ``noise_std``.
    draw : ``(generator, n_frames) -> (bits, noise, *channel)``, the
        random inputs of ``transceive``, drawn from the generator in one
        fixed order.
    """

    link_step: Callable
    frame_bits: int
    noise_std_fn: Callable  # snr_db -> noise_std
    name: str = "link"
    extras: dict = field(default_factory=dict)
    transceive: Optional[Callable] = None
    n_symbols: int = 0
    receive: Optional[Callable] = None
    decode: Optional[Callable] = None
    draw: Optional[Callable] = None


def _gen_bits(generator: torch.Generator, n_frames: int, n_bits: int,
              device) -> torch.Tensor:
    """Uniform random bits ``[F, n_bits]`` int8."""
    return torch.randint(0, 2, (n_frames, n_bits), generator=generator,
                         device=device, dtype=torch.int8)


def _counting_step(draw, transceive):
    """``link_step`` from a link's ``draw`` and ``transceive``: the bit
    errors of the frames (of ``rows`` of them, if given)."""

    def link_step(generator, n_frames, noise_std, rows=None):
        with span("link.draw"):
            bits, noise, *channel = draw(generator, n_frames)
            if rows is not None:
                bits, noise, *channel = (x[rows] for x in (bits, noise,
                                                           *channel))
        dec = transceive(bits, noise, noise_std, *channel)
        with span("link.count_errors"):
            return torch.sum(torch.bitwise_xor(dec, bits), dtype=torch.int32)

    return link_step


def make_conv_awgn_link(
    *,
    trellis: Trellis,
    modulation_m: int = 2,
    frame_bits: int = 1000,
    decoding_type: str = "soft",
    tb_depth: Optional[int] = None,
    puncture: Optional[list] = None,
    use_psk: bool = True,
    scramble_seed: Optional[int] = None,
    name: str = "conv-awgn",
    device="cuda",
) -> DeviceLink:
    """Conv-coded link over complex AWGN.

    PSK(2) with ``decoding_type='hard'``/``'unquantized'``, or QAM(m) with
    ``'soft'`` (the 802.11 configuration).  ``puncture`` is a puncturing
    pattern; ``scramble_seed`` (non-zero 7-bit int) inserts the 802.11
    frame-synchronous scrambler before the encoder and the descrambler
    after the decoder.
    """
    dev = resolve_device(device)
    const = (M.psk_constellation(modulation_m) if use_psk
             else M.qam_constellation(modulation_m))
    Es = float(np.mean(np.abs(const) ** 2))  # on the host, in float64
    const = const.astype(np.complex64)
    bps = int(np.log2(modulation_m))
    k, n = trellis.k, trellis.n
    n_coded = frame_bits * n // k
    if puncture is not None:
        keep = puncture_mask(puncture, n_coded)
        keep_idx = device_constant(np.where(keep)[0], dev)
        n_kept = int(keep.sum())
        rate = frame_bits / n_kept
    else:
        keep = None
        n_kept = n_coded
        rate = k / n
    if n_kept % bps:
        raise ValueError("frame size must fill whole symbols")
    if decoding_type == "unquantized" and modulation_m != 2:
        raise ValueError("unquantized decoding takes BPSK only")
    n_sym = n_kept // bps
    if tb_depth is None:
        tb_depth = min(5 * trellis.total_memory, frame_bits)

    def receive(bits, noise, noise_std):
        with span("link.encode"):
            tx = (bits if scramble_seed is None
                  else scramble(bits, scramble_seed, device=dev))
            coded, _ = encode_scan(tx, trellis, device=dev)  # [F, n_coded]
            if keep is not None:
                coded = coded[:, keep_idx]
        with span("link.modulate_channel"):
            symbols = M.modulate(coded, const, bps, device=dev)  # [F, n_sym]
            ns = np.float32(noise_std)
            y = symbols + on_device(noise, dev) * float(ns * np.float32(0.5))
        with span("link.demodulate"):
            if decoding_type == "soft":
                rx = M.demodulate_soft(y, const, bps, ns * ns)
            elif decoding_type == "hard":
                rx = M.demodulate_hard(y, const, bps).to(torch.float32)
            else:  # unquantized, BPSK: bit b maps to symbol 1 - 2b
                rx = -y.real
            if keep is not None:
                rx = depuncture_device(rx, keep)
        return rx

    def decode(rx):
        with span("link.viterbi"):
            dec = viterbi_decode_device(rx, trellis, tb_depth, decoding_type,
                                        L=frame_bits, device=dev)
            if scramble_seed is not None:
                dec = descramble(dec, scramble_seed, device=dev)
        return dec

    def transceive(bits, noise, noise_std):
        return decode(receive(bits, noise, noise_std))

    def draw(generator, n_frames):
        return (_gen_bits(generator, n_frames, frame_bits, dev),
                crandn(generator, (n_frames, n_sym), dev))

    def noise_std_fn(snr_db):
        return snr_to_noise_std(snr_db, code_rate=rate, Es=Es)

    return DeviceLink(_counting_step(draw, transceive), frame_bits,
                      noise_std_fn, name,
                      {"rate": rate, "Es": Es, "bps": bps,
                       "trellis": trellis, "decoding_type": decoding_type},
                      transceive, n_sym, receive, decode, draw)


def make_turbo_awgn_link(
    *,
    trellis: Trellis,
    frame_bits: int,
    p_array,
    n_iterations: int = 8,
    window=None,
    window_init: str = "warmup",
    kernel_io: str = "f32",
    name: str = "turbo-awgn",
    device="cuda",
) -> DeviceLink:
    """Rate-1/3 PCCC turbo link over real-BPSK AWGN.

    bits -> :func:`~commpy_tpu_torch.ops.turbo.turbo_encode_device` ->
    BPSK (bit b -> 2b-1) -> ``+ noise * noise_std`` -> turbo decode ->
    XOR count.  ``window`` / ``window_init`` / ``kernel_io`` pass through
    to :func:`~commpy_tpu_torch.ops.turbo.turbo_decode_device` (the K3
    route on the card); long frames should run ``window=(128, 0),
    window_init='nii'``.  ``noise_std_fn`` is for real noise at rate 1/3,
    so the link's SNR is Eb/N0 + 3.01 dB.
    """
    dev = resolve_device(device)
    rate = 1.0 / 3.0
    p_array = np.asarray(p_array, np.int64)
    if p_array.size != frame_bits:
        raise ValueError(f"p_array has {p_array.size} entries, the frame "
                         f"{frame_bits} bits")

    def receive(bits, noise, noise_std):
        with span("link.encode"):
            sys_b, par1_b, par2_b = turbo_encode_device(
                bits, trellis, trellis, p_array, device=dev)
            tx = 2.0 * torch.stack([sys_b, par1_b, par2_b], -1).to(
                torch.float32) - 1.0  # [F, L, 3]
        with span("link.modulate_channel"):
            return tx + on_device(noise, dev) * float(np.float32(noise_std))

    def decode(y, noise_std):
        with span("link.turbo_decode"):
            ns = np.float32(noise_std)
            return turbo_decode_device(
                y[..., 0], y[..., 1], y[..., 2], trellis, ns * ns,
                n_iterations, p_array, window=window,
                window_init=window_init, kernel_io=kernel_io, device=dev)

    def transceive(bits, noise, noise_std):
        return decode(receive(bits, noise, noise_std), noise_std)

    def draw(generator, n_frames):
        return (_gen_bits(generator, n_frames, frame_bits, dev),
                torch.randn((n_frames, frame_bits, 3), generator=generator,
                            device=dev))

    def noise_std_fn(snr_db):
        # real channel: noise_std = sqrt(Es / (rate * snr))
        return snr_to_noise_std(snr_db, code_rate=rate, Es=1.0,
                                is_complex=False)

    return DeviceLink(_counting_step(draw, transceive), frame_bits,
                      noise_std_fn, name, {"rate": rate}, transceive,
                      3 * frame_bits, receive, decode, draw)


_SQRT_HALF = float(np.sqrt(np.float32(0.5)))


def make_lte_turbo_link(
    *,
    block_bits: int = 6144,
    f1: int = 263,
    f2: int = 480,
    n_iterations: int = 8,
    window: int = 128,
    name: str = "lte-turbo",
    device="cuda",
) -> DeviceLink:
    """One LTE turbo code block over LTE's 16-QAM and complex AWGN.

    bits ``[F, K]`` -> the terminated PCCC of 3GPP TS 36.212 5.1.3.2
    (:func:`~commpy_tpu_torch.ops.turbo.lte_trellis` twice, the QPP
    interleaver (``f1``, ``f2``), 12 tail bits) -> d(0) followed by d(1)
    and d(2) interlaced, 3 (K + 4) bits at the mother rate (the bit
    collection of 5.1.4.1.2 without its sub-block interleavers: no rate
    matching) -> 16-QAM (TS 36.211 7.1.3) -> complex AWGN, ``y = s + n
    * noise_std / 2`` -> exact LLRs (K6 on the card) at the noise's
    complex variance ``noise_std^2 / 2`` -> log-MAP turbo decode, K3 on
    windows of ``window`` steps with NII, the tail's beta ending each
    frame -> XOR count.

    The decoder's branch model is BPSK (bit b -> 2b - 1) scaled by
    1/noise_variance; an exact LLR ``l`` (positive for bit 1) is that
    model's ``2 y / nv``, so the decoder takes ``l / 2`` at unit noise
    variance.  ``noise_std_fn`` is ``snr_to_noise_std`` at the code rate
    K / (3 (K + 4)) and the constellation's Es, as the other QAM links.
    """
    dev = resolve_device(device)
    K = int(block_bits)
    if K % window:
        raise ValueError(f"window {window} must divide the block {K}")
    trellis = lte_trellis()
    p_array = qpp_interleaver(K, f1, f2)
    const = M.lte_16qam_constellation()
    Es = float(np.mean(np.abs(const) ** 2))  # on the host, in float64
    const = const.astype(np.complex64)
    bps = 4
    D = K + 4
    n_coded = 3 * D  # whole symbols: every LTE block size is a multiple of 8

    def receive(bits, noise, noise_std):
        with span("link.encode"):
            d0, d1, d2 = turbo_encode_device(on_device(bits, dev), trellis,
                                             trellis, p_array, device=dev,
                                             terminate=True)
            coded = torch.cat([d0, torch.stack([d1, d2], -1).flatten(-2)],
                              -1)
        with span("link.modulate_channel"):
            ns = np.float32(noise_std)
            y = (M.modulate(coded, const, bps, device=dev)
                 + on_device(noise, dev) * float(ns * np.float32(0.5)))
        with span("link.demodulate"):
            return M.demodulate_soft(y, const, bps,
                                     ns * ns * np.float32(0.5))

    def decode(llr):
        with span("link.turbo_decode"):
            w = llr * 0.5
            d0, d1, d2 = w[:, :D], w[:, D::2], w[:, D + 1::2]
            return turbo_decode_device(
                d0[:, :K], d1[:, :K], d2[:, :K], trellis, 1.0, n_iterations,
                p_array, window=(window, 0), window_init="nii",
                tail=tail_streams(d0, d1, d2), device=dev)

    rate = K / n_coded
    return _link_parts(
        name, dev, receive, decode, K,
        lambda snr_db: snr_to_noise_std(snr_db, code_rate=rate, Es=Es),
        {"rate": rate, "Es": Es, "bps": bps, "trellis": trellis},
        (n_coded // bps,))


def _link_parts(name, dev, receive, decode, frame_bits, noise_std_fn,
                extras, noise_shape, channel_shape=None,
                channel_scale=_SQRT_HALF):
    """The ``DeviceLink`` of a link from its two stages.

    ``draw`` makes the bits, unit complex noise ``[F, *noise_shape]``
    and, for a link with a channel, ``crandn([F, *channel_shape]) *
    channel_scale``; ``link_step`` counts the errors of ``transceive`` on
    them.
    """

    def transceive(bits, noise, noise_std, *h):
        return decode(receive(bits, noise, noise_std, *h))

    def draw(generator, n_frames):
        bits = _gen_bits(generator, n_frames, frame_bits, dev)
        noise = crandn(generator, (n_frames,) + noise_shape, dev)
        if channel_shape is None:
            return bits, noise
        return bits, noise, (crandn(generator, (n_frames,) + channel_shape,
                                    dev) * channel_scale)

    return DeviceLink(_counting_step(draw, transceive), frame_bits,
                      noise_std_fn, name,
                      dict(extras, noise_shape=noise_shape,
                           channel_shape=channel_shape,
                           channel_scale=channel_scale),
                      transceive, int(np.prod(noise_shape)), receive, decode,
                      draw)


def _constellation(modulation_m, use_psk):
    const = (M.psk_constellation(modulation_m) if use_psk
             else M.qam_constellation(modulation_m))
    Es = float(np.mean(np.abs(const) ** 2))  # on the host, in float64
    return const.astype(np.complex64), Es, int(np.log2(modulation_m))


def make_qcldpc_awgn_link(
    *,
    qc_params: dict,
    modulation_m: int = 4,
    algorithm: str = "MSA",
    n_iterations: int = 15,
    msa_scale: float = 1.0,
    msa_offset: float = 0.0,
    use_psk: bool = False,
    schedule: str = "flooding",
    name: str = "qcldpc-awgn",
    device="cuda",
) -> DeviceLink:
    """QC-LDPC-coded QAM/PSK link over complex AWGN.

    One frame is one QC codeword, decoded by
    :func:`~commpy_tpu_torch.ops.qcldpc.qc_bp_decode_device` (flooding,
    ``backend='auto'``: the resident kernel K4 on the card for every
    802.11n code).  ``schedule='layered'`` decodes by the layered
    schedule instead, which takes codes past K4's plan (a DVB-S2-class
    Z=360) onto the streamed kernel K5.
    """
    dev = resolve_device(device)
    n_v = qc_params["n_vnodes"]
    frame_bits = qc_params["k_bits"]
    const, Es, bps = _constellation(modulation_m, use_psk)
    if n_v % bps:
        raise ValueError(
            f"codeword length {n_v} must fill whole {bps}-bit symbols")
    encode = qc_encoder(qc_params, dev)

    def receive(bits, noise, noise_std):
        with span("link.encode"):
            coded = encode(on_device(bits, dev))  # [F, n_v]
        with span("link.modulate_channel"):
            ns = np.float32(noise_std)
            y = (M.modulate(coded, const, bps, device=dev)
                 + on_device(noise, dev) * float(ns * np.float32(0.5)))
        with span("link.demodulate"):
            return -M.demodulate_soft(y, const, bps, ns * ns)

    def decode(llr):
        with span("link.ldpc_decode"):
            dec, _ = qc_bp_decode_device(llr, qc_params, algorithm,
                                         n_iterations, schedule=schedule,
                                         msa_scale=msa_scale,
                                         msa_offset=msa_offset, device=dev)
            return dec[..., :frame_bits]

    rate = frame_bits / n_v
    return _link_parts(
        name, dev, receive, decode, frame_bits,
        lambda snr_db: snr_to_noise_std(snr_db, code_rate=rate, Es=Es),
        {"n": n_v, "rate": rate, "Es": Es}, (n_v // bps,))


def make_ldpc_rayleigh_link(
    *,
    ldpc_params: dict,
    modulation_m: int = 4,
    algorithm: str = "SPA",
    n_iterations: int = 50,
    fading: bool = True,
    name: str = "ldpc-rayleigh",
    device="cuda",
) -> DeviceLink:
    """LDPC-coded QAM link over a Rayleigh-faded (or, with
    ``fading=False``, a plain) SISO channel.

    One frame is one LDPC codeword; the receiver equalises with perfect
    CSI, ``z = y / h``, and demaps with the per-symbol noise variance
    ``noise_var / max(|h|^2, 1e-12)``.  The channel gains are complex
    normals scaled by sqrt(0.5); ``transceive`` and ``receive`` take them
    as a fourth argument when ``fading`` is on.  Decoding is
    :func:`~commpy_tpu_torch.ops.ldpc.ldpc_bp_decode_device`, which lifts
    QC designs (WiMAX) onto the QC decoder.
    """
    dev = resolve_device(device)
    if ldpc_params.get("generator_matrix") is None:
        build_matrix(ldpc_params)
    G = np.asarray(ldpc_params["generator_matrix"].todense()) % 2
    n_v = ldpc_params["n_vnodes"]
    frame_bits = n_v - ldpc_params["n_cnodes"]
    const, Es, bps = _constellation(modulation_m, False)
    if n_v % bps:
        raise ValueError(
            f"codeword length {n_v} must fill whole {bps}-bit symbols")
    G_dev = torch.as_tensor(G.astype(np.int8), device=dev)

    def receive(bits, noise, noise_std, *h):
        with span("link.encode"):
            coded = ldpc_encode_device(bits, G_dev, device=dev)  # [F, n_v]
        with span("link.modulate_channel"):
            symbols = M.modulate(coded, const, bps, device=dev)
            ns = np.float32(noise_std)
            gain = on_device(h[0], dev) if fading else torch.ones_like(
                symbols)
            y = gain * symbols + on_device(noise, dev) * float(
                ns * np.float32(0.5))
        with span("link.demodulate"):
            # perfect-CSI equalisation; effective per-symbol noise variance
            z = y / gain
            nv = torch.full((), float(ns * ns), dtype=torch.float32,
                            device=dev)
            nv_eff = nv / torch.clamp_min(torch.abs(gain) ** 2, 1e-12)
            return -M.demodulate_soft(z, const, bps, nv_eff)

    def decode(llr):
        with span("link.ldpc_decode"):
            dec, _ = ldpc_bp_decode_device(llr, ldpc_params, algorithm,
                                           n_iterations, device=dev)
            return dec[..., :frame_bits]

    rate = frame_bits / n_v
    return _link_parts(
        name, dev, receive, decode, frame_bits,
        lambda snr_db: snr_to_noise_std(snr_db, code_rate=rate, Es=Es),
        {"n": n_v, "rate": rate, "Es": Es}, (n_v // bps,),
        (n_v // bps,) if fading else None)


def _noisy(signal, noise, noise_std):
    """``signal + noise * (noise_std * 0.5)`` in float32."""
    ns = np.float32(noise_std)
    return signal + on_device(noise, signal.device) * float(
        ns * np.float32(0.5))


def _mimo_channel(x, h, noise, noise_std):
    """``y[f, v] = h[f, v] @ x[f, v] + noise`` (float32 sums over the
    transmit antennas)."""
    h = on_device(h, x.device)
    return _noisy(small_matmul(h, x[..., None])[..., 0], noise, noise_std), h


def make_kbest_mimo_link(
    *,
    nb_tx: int = 4,
    nb_rx: int = 4,
    modulation_m: int = 16,
    K: int = 16,
    vectors_per_frame: int = 32,
    name: str = "kbest-mimo",
    device="cuda",
) -> DeviceLink:
    """Uncoded K-best detection over uncorrelated Rayleigh MIMO (the
    reference's test_links.py:55-58 configuration): QAM vectors of
    ``nb_tx`` symbols through ``h [nb_rx, nb_tx]`` (a fresh channel a
    vector, entries complex normal of variance 1), hard K-best
    detection, hard demapping."""
    dev = resolve_device(device)
    const, Es, bps = _constellation(modulation_m, False)
    nv = vectors_per_frame
    frame_bits = nv * nb_tx * bps

    def receive(bits, noise, noise_std, h):
        F = bits.shape[0]
        with span("link.modulate_channel"):
            x = M.modulate(bits, const, bps, device=dev).reshape(F, nv, nb_tx)
            y, h = _mimo_channel(x, h, noise, noise_std)
        with span("link.detect"):
            xh = kbest_device(y.reshape(-1, nb_rx),
                              h.reshape(-1, nb_rx, nb_tx), const, K,
                              device=dev)
            return xh.reshape(F, -1)

    def decode(xh):
        with span("link.demodulate"):
            return M.demodulate_hard(xh, const, bps)

    def noise_std_fn(snr_db):
        return snr_to_noise_std(snr_db, code_rate=1.0, Es=Es, nb_tx=nb_tx)

    return _link_parts(name, dev, receive, decode, frame_bits, noise_std_fn,
                       {"Es": Es, "bps": bps}, (nv, nb_rx),
                       (nv, nb_rx, nb_tx))


def make_bestfirst_ldpc_mimo_link(
    *,
    ldpc_params: dict,
    nb_tx: int = 4,
    nb_rx: int = 4,
    modulation_m: int = 16,
    beam=32,
    llr_max: float = 500.0,
    algorithm: str = "MSA",
    n_iterations: int = 15,
    detector: str = "bestfirst",
    name: str = "bestfirst-ldpc-mimo",
    device="cuda",
) -> DeviceLink:
    """LDPC-coded MIMO link with batched soft detection (the reference's
    tier-3 acceptance model, test_links.py:60-86): WiMAX LDPC(1440,720)
    encode -> 16-QAM -> 4x4 uncorrelated Rayleigh -> soft detector LLRs ->
    MSA-15 BP decode.  One frame is one codeword.

    ``detector='bestfirst'`` uses
    :func:`~commpy_tpu_torch.ops.mimo.best_first_device` (unscaled metric
    differences, positive <=> bit 0: MSA decisions do not depend on the
    missing 1/(2 sigma^2)); ``detector='kbest'`` uses ``kbest_device``'s
    max-log soft output with K = ``beam`` (its last entry for a tuple).
    Decoding is :func:`~commpy_tpu_torch.ops.ldpc.ldpc_bp_decode_device`,
    which lifts WiMAX to its QC form: K4 on the card.
    """
    if detector not in ("bestfirst", "kbest"):
        raise ValueError(f"unknown detector {detector!r}")
    dev = resolve_device(device)
    if ldpc_params.get("generator_matrix") is None:
        build_matrix(ldpc_params)
    G = np.asarray(ldpc_params["generator_matrix"].todense()) % 2
    G_dev = torch.as_tensor(G.astype(np.int8), device=dev)
    n_v = ldpc_params["n_vnodes"]
    frame_bits = n_v - ldpc_params["n_cnodes"]
    const, Es, bps = _constellation(modulation_m, False)
    rate = frame_bits / n_v
    n_sym = n_v // bps
    if n_v % bps or n_sym % nb_tx:
        raise ValueError(f"codeword length {n_v} must fill whole {bps}-bit "
                         f"symbols and whole {nb_tx}-symbol vectors")
    n_vec = n_sym // nb_tx
    K = int(beam) if np.ndim(beam) == 0 else int(beam[-1])

    def receive(bits, noise, noise_std, h):
        F = bits.shape[0]
        with span("link.encode"):
            coded = ldpc_encode_device(bits, G_dev, device=dev)  # [F, n_v]
        with span("link.modulate_channel"):
            x = M.modulate(coded, const, bps, device=dev).reshape(
                F, n_vec, nb_tx)
            y, h = _mimo_channel(x, h, noise, noise_std)
        with span("link.detect"):
            yv, hv = y.reshape(-1, nb_rx), h.reshape(-1, nb_rx, nb_tx)
            if detector == "kbest":
                ns = np.float32(noise_std)
                llrs = kbest_device(yv, hv, const, K, ns * ns, "soft", bps,
                                    device=dev)
            else:
                llrs = best_first_device(yv, hv, const, beam=beam,
                                         llr_max=llr_max,
                                         bits_per_symbol=bps, device=dev)
            return llrs.reshape(F, n_v)  # positive <=> bit 0

    def decode(llrs):
        with span("link.ldpc_decode"):
            dec, _ = ldpc_bp_decode_device(llrs, ldpc_params, algorithm,
                                           n_iterations, device=dev)
            return dec[..., :frame_bits]

    def noise_std_fn(snr_db):
        return snr_to_noise_std(snr_db, code_rate=rate, Es=Es, nb_tx=nb_tx)

    return _link_parts(name, dev, receive, decode, frame_bits, noise_std_fn,
                       {"rate": rate, "Es": Es, "bps": bps, "n": n_v,
                        "detector": detector}, (n_vec, nb_rx),
                       (n_vec, nb_rx, nb_tx))


def make_ofdm_mimo_conv_link(
    *,
    trellis: Trellis,
    modulation_m: int = 16,
    nb_tx: int = 2,
    nb_rx: int = 2,
    K: int = 8,
    nfft: int = 64,
    nsc: int = 48,
    cp_length: int = 16,
    n_ofdm_symbols: int = 4,
    name: str = "ofdm-mimo-conv",
    device="cuda",
) -> DeviceLink:
    """802.11ac-style link (BASELINE configuration 5): conv code -> QAM ->
    OFDM -> 2x2 flat MIMO -> K-best soft detection -> soft Viterbi.

    Block fading: one channel matrix a frame, shared by all subcarriers.
    The FFT pair is ifft (1/N) at the transmitter and fft at the receiver,
    so the per-subcarrier noise variance is ``nfft`` times the time
    domain's; ``noise_std_fn`` calibrates the per-subcarrier SNR.
    """
    dev = resolve_device(device)
    const, Es, bps = _constellation(modulation_m, False)
    k, n = trellis.k, trellis.n
    rate = k / n
    n_sym = nsc * n_ofdm_symbols * nb_tx  # QAM symbols a frame
    n_coded = n_sym * bps
    frame_bits = n_coded * k // n
    tb_depth = min(5 * trellis.total_memory, frame_bits)
    n_vec = nsc * n_ofdm_symbols
    T = n_ofdm_symbols * (nfft + cp_length)

    def receive(bits, noise, noise_std, h):
        F = bits.shape[0]
        with span("link.encode"):
            coded, _ = encode_scan(bits, trellis, device=dev)
        with span("link.modulate_channel"):
            symbols = M.modulate(coded, const, bps, device=dev)
            grids = symbols.reshape(F, nb_tx, n_ofdm_symbols, nsc).movedim(
                -1, -2)  # [F, nt, nsc, n_ofdm]
            tx_time = OFDM.ofdm_tx(grids, nfft, nsc, cp_length, dev)
            h = on_device(h, dev)
            rx_time = _noisy(small_matmul(h, tx_time), noise, noise_std)
        with span("link.detect"):
            rx_grids = OFDM.ofdm_rx(rx_time, nfft, nsc, cp_length, dev)
            rx_vec = rx_grids.movedim(1, -1)  # [F, nsc, n_ofdm, nr]
            h_rep = h[:, None].expand(F, n_vec, nb_rx, nb_tx)
            ns = np.float32(noise_std)
            noise_var = ns * ns * np.float32(nfft)
            llrs = kbest_device(rx_vec.reshape(-1, nb_rx),
                                h_rep.reshape(-1, nb_rx, nb_tx), const, K,
                                noise_var, "soft", bps, device=dev)
            # undo the tx layout [nb_tx, n_ofdm, nsc]; the detector's
            # positive => bit 0 becomes the soft Viterbi's positive => bit 1
            llrs = llrs.reshape(F, nsc, n_ofdm_symbols, nb_tx, bps)
            return -llrs.permute(0, 3, 2, 1, 4).reshape(F, -1)

    def decode(llrs):
        with span("link.viterbi"):
            return viterbi_decode_device(llrs, trellis, tb_depth, "soft",
                                         L=frame_bits, device=dev)

    def noise_std_fn(snr_db):
        return snr_to_noise_std(snr_db, code_rate=rate, Es=Es,
                                nb_tx=nb_tx) / np.sqrt(nfft)

    return _link_parts(name, dev, receive, decode, frame_bits, noise_std_fn,
                       {"rate": rate, "Es": Es, "bps": bps,
                        "trellis": trellis, "decoding_type": "soft"},
                       (nb_rx, T), (nb_rx, nb_tx))


def make_ofdm_qcldpc_link(
    *,
    qc_params: dict,
    modulation_m: int = 4,
    nfft: int = 64,
    nsc: int = 54,
    cp_length: int = 16,
    n_taps: int = 4,
    algorithm: str = "MSA",
    n_iterations: int = 15,
    msa_scale: float = 1.0,
    csi: str = "perfect",
    cfo: float = 0.0,
    cfo_correction: bool = False,
    name: str = "ofdm-qcldpc",
    device="cuda",
) -> DeviceLink:
    """802.11n-style OFDM PHY with QC-LDPC coding over a multipath channel.

    One frame is one QC codeword spread over an OFDM grid; the channel is
    an ``n_taps``-tap Rayleigh delay line (time-domain convolution, the
    CP absorbs the delay spread), so subcarriers fade selectively.  Per
    subcarrier equalization with the per-subcarrier noise variance feeds
    the exact-LLR demapper, then
    :func:`~commpy_tpu_torch.ops.qcldpc.qc_bp_decode_device` (K4 on the
    card for the 802.11n codes).

    ``csi``: "perfect" uses the true per-subcarrier response; "ls"
    prepends one known BPSK pilot OFDM symbol and least-squares-estimates
    ``H = rx_pilot / pilot``; "smooth" also projects the LS estimate onto
    the ``n_taps`` delay subspace
    (:func:`~commpy_tpu_torch.ops.ofdm.delay_subspace_matrix`).

    ``cfo`` applies a normalized carrier frequency offset (subcarrier
    spacings) to the received waveform; ``cfo_correction=True`` runs the
    CP-correlation estimator and derotates before OFDM demodulation.
    """
    dev = resolve_device(device)
    n_v = qc_params["n_vnodes"]
    frame_bits = qc_params["k_bits"]
    const, Es, bps = _constellation(modulation_m, False)
    rate = frame_bits / n_v
    n_sym = n_v // bps
    if n_v % bps or n_sym % nsc:
        raise ValueError(
            f"codeword ({n_v} bits, {n_sym} symbols) must fill whole "
            f"{bps}-bit symbols and whole {nsc}-subcarrier OFDM symbols")
    n_ofdm = n_sym // nsc
    if n_taps > cp_length:
        raise ValueError("delay spread must fit inside the cyclic prefix")
    if csi not in ("perfect", "ls", "smooth"):
        raise ValueError('csi must be "perfect", "ls" or "smooth"')
    # DFT vectors of the mapped bins: H = W @ g  ([nsc, n_taps])
    bins = OFDM.subcarrier_bins(nfft, nsc)
    W = np.exp(-2j * np.pi * bins[:, None] * np.arange(n_taps)[None, :]
               / nfft).astype(np.complex64)
    smooth_t = (np.ascontiguousarray(
        OFDM.delay_subspace_matrix(nfft, nsc, n_taps).T)
        if csi == "smooth" else None)
    # BPSK pilot with the average data symbol energy
    pilot = (np.sqrt(Es) * (1.0 - 2.0 * (np.arange(nsc) % 2))).astype(
        np.complex64)
    n_blocks = n_ofdm + (csi != "perfect")
    T = n_blocks * (nfft + cp_length)
    encode = qc_encoder(qc_params, dev)

    def receive(bits, noise, noise_std, g):
        F = bits.shape[0]
        with span("link.encode"):
            coded = encode(on_device(bits, dev))  # [F, n_v]
        with span("link.modulate_channel"):
            symbols = M.modulate(coded, const, bps, device=dev)
            grids = symbols.reshape(F, n_ofdm, nsc).movedim(-1, -2)
            if csi != "perfect":
                pgrid = device_constant(pilot, dev)[None, :, None].expand(
                    F, nsc, 1)
                grids = torch.cat([pgrid, grids], dim=-1)
            tx = OFDM.ofdm_tx(grids, nfft, nsc, cp_length, dev)  # [F, T]
            g = on_device(g, dev)
            rx = torch.zeros_like(tx)
            for tap in range(n_taps):  # y[t] = sum_l g_l x[t-l]
                shifted = tx if tap == 0 else torch.nn.functional.pad(
                    tx, (tap, 0))[:, :tx.shape[1]]
                rx = rx + g[:, tap:tap + 1] * shifted
            if cfo:
                rx = add_frequency_offset(rx, float(nfft), cfo, dev)
            rx = _noisy(rx, noise, noise_std)
        with span("link.sync_equalize"):
            if cfo_correction:
                eps = cfo_estimate_cp(rx, nfft, cp_length, n_blocks, dev)
                rx = cfo_correct(rx, eps, nfft, device=dev)
            rx_grids = OFDM.ofdm_rx(rx, nfft, nsc, cp_length, dev)
            if csi != "perfect":
                H = rx_grids[:, :, 0] / device_constant(pilot, dev)
                if smooth_t is not None:
                    H = small_matmul(H[:, None, :], device_constant(
                        smooth_t, dev))[:, 0, :]
                rx_grids = rx_grids[:, :, 1:]
            else:
                H = small_matmul(g[:, None, :], device_constant(
                    np.ascontiguousarray(W.T), dev))[:, 0, :]  # [F, nsc]
            z = rx_grids / H[:, :, None]
            ns = np.float32(noise_std)
            noise_var = float(ns * ns * np.float32(nfft))
            nv_eff = noise_var / torch.clamp_min(
                torch.abs(H[:, :, None]) ** 2, 1e-12)
            z = z.movedim(-1, -2).reshape(F, n_sym)
            nv_eff = nv_eff.expand(F, nsc, n_ofdm).movedim(-1, -2).reshape(
                F, n_sym)
        with span("link.demodulate"):
            return -M.demodulate_soft(z, const, bps, nv_eff)

    def decode(llr):
        with span("link.ldpc_decode"):
            dec, _ = qc_bp_decode_device(llr, qc_params, algorithm,
                                         n_iterations, msa_scale=msa_scale,
                                         device=dev)
            return dec[..., :frame_bits]

    def noise_std_fn(snr_db):
        # per-subcarrier SNR (reference channels.py:74); the time-domain
        # std is that over sqrt(nfft) (the FFT's gain); the unit-energy
        # delay line keeps the average
        return snr_to_noise_std(snr_db, code_rate=rate, Es=Es) / np.sqrt(nfft)

    return _link_parts(name, dev, receive, decode, frame_bits, noise_std_fn,
                       {"rate": rate, "Es": Es, "bps": bps, "n": n_v,
                        "n_ofdm_symbols": n_ofdm, "csi": csi, "cfo": cfo},
                       (T,), (n_taps,),
                       float(np.sqrt(np.float32(0.5 / n_taps))))


def make_rrc_conv_awgn_link(
    *,
    trellis: Trellis,
    modulation_m: int = 16,
    frame_bits: int = 1200,
    sps: int = 4,
    rrc_span_symbols: int = 8,
    rrc_alpha: float = 0.35,
    decoding_type: str = "soft",
    use_maxlog: bool = True,
    name: str = "rrc-conv-awgn",
    device="cuda",
) -> DeviceLink:
    """Waveform-level conv-coded link: bits -> conv encode -> QAM ->
    upsample x ``sps`` + RRC pulse shaping (polyphase) -> complex AWGN at
    the sample rate -> matched filter -> symbol-spaced sampling -> LLR
    demapping (max-log by default) -> soft Viterbi (K1/K2 on the card).

    The RRC taps have unit energy, so the matched-filter cascade is
    ISI-free Nyquist with unity gain and the symbol-level SNR calibration
    is the symbol-rate link's.  An even tap count puts the filter peak on
    a sample, so the cascade delay is ``n_taps`` samples.  The noise is
    ``[F, (n_sym-1)*sps + n_taps]``; the matched filter and the sampling
    run in the ``link.demodulate`` span.
    """
    dev = resolve_device(device)
    const, Es, bps = _constellation(modulation_m, False)
    k, n = trellis.k, trellis.n
    rate = k / n
    n_coded = frame_bits * n // k
    if n_coded % bps:
        raise ValueError("frame size must fill whole symbols")
    n_sym = n_coded // bps
    tb_depth = min(5 * trellis.total_memory, frame_bits)
    n_taps = sps * rrc_span_symbols
    _, taps = rrcosfilter(n_taps, rrc_alpha, 1.0, float(sps))
    taps = (taps / np.sqrt(np.sum(taps ** 2))).astype(np.float32)
    delay = n_taps  # transmit filter + matched filter group delay
    demod = M.demodulate_maxlog if use_maxlog else M.demodulate_soft

    def receive(bits, noise, noise_std):
        taps_d = device_constant(taps, dev)
        with span("link.encode"):
            coded, _ = encode_scan(bits, trellis, device=dev)
        with span("link.modulate_channel"):
            symbols = M.modulate(coded, const, bps, device=dev)
            wave = upfirdn(symbols, taps_d, up=sps, device=dev)
            y = _noisy(wave, noise, noise_std)
        with span("link.demodulate"):
            mf = fir_filter(y, taps_d, "full", device=dev)
            sampled = mf[:, delay:delay + n_sym * sps:sps]
            ns = np.float32(noise_std)
            return demod(sampled, const, bps, ns * ns)

    def decode(llr):
        with span("link.viterbi"):
            return viterbi_decode_device(llr, trellis, tb_depth,
                                         decoding_type, L=frame_bits,
                                         device=dev)

    return _link_parts(
        name, dev, receive, decode, frame_bits,
        lambda snr_db: snr_to_noise_std(snr_db, code_rate=rate, Es=Es),
        {"rate": rate, "Es": Es, "bps": bps, "sps": sps, "trellis": trellis,
         "decoding_type": decoding_type}, ((n_sym - 1) * sps + n_taps,))


def make_isi_conv_link(
    *,
    trellis: Trellis,
    channel_taps,
    n_eq_taps: int = 21,
    modulation_m: int = 4,
    frame_bits: int = 1000,
    tb_depth: Optional[int] = None,
    name: str = "isi-conv-awgn",
    device="cuda",
) -> DeviceLink:
    """Conv-coded PSK link over a static frequency-selective (ISI)
    channel with MMSE linear equalization.

    bits -> conv encode -> PSK -> channel convolution + AWGN -> MMSE FIR
    equalizer (taps designed for the step's noise level) -> exact-LLR
    demapping with the Wiener MSE (residual ISI + enhanced noise) as the
    noise variance -> soft Viterbi (K1/K2 on the card).
    """
    dev = resolve_device(device)
    h_np = np.asarray(channel_taps, np.complex64)
    h_energy = float(np.sum(np.abs(h_np) ** 2))
    const, Es, bps = _constellation(modulation_m, True)
    k, n = trellis.k, trellis.n
    n_coded = frame_bits * n // k
    if n_coded % bps:
        raise ValueError("frame size must fill whole symbols")
    n_sym = n_coded // bps
    rate = k / n
    if tb_depth is None:
        tb_depth = min(5 * trellis.total_memory, frame_bits)
    delay = equalizer_delay(n_eq_taps, len(h_np))

    def receive(bits, noise, noise_std):
        h = device_constant(h_np, dev)
        with span("link.encode"):
            coded, _ = encode_scan(bits, trellis, device=dev)
        with span("link.modulate_channel"):
            symbols = M.modulate(coded, const, bps, device=dev)
            rx = fir_filter(symbols, h, "full", device=dev)[..., :n_sym]
            y = _noisy(rx, noise, noise_std)
        with span("link.equalize"):
            # MMSE design at this noise level (PSK symbols have unit
            # power; noise_var is the complex variance)
            ns = np.float32(noise_std)
            noise_var = ns * ns
            w = mmse_fir_taps(h, float(noise_var), n_eq_taps, device=dev)
            z = equalize(y, w, delay, device=dev)
            # post-equalizer error variance = the Wiener MSE,
            # 1 - Re(sum(p * w)) with u = conj(w)
            pvec = _conv_matrix(h, n_eq_taps)[:, delay]
            mse = 1.0 - torch.sum(pvec * w).real
            mse = torch.clamp_min(mse, float(noise_var * np.float32(1e-2)))
        with span("link.demodulate"):
            return M.demodulate_soft(z, const, bps, mse.reshape(1))

    def decode(llr):
        with span("link.viterbi"):
            return viterbi_decode_device(llr, trellis, tb_depth, "soft",
                                         L=frame_bits, device=dev)

    def noise_std_fn(snr_db):
        # the channel's gain counts into Es
        return snr_to_noise_std(snr_db, code_rate=rate, Es=Es * h_energy)

    return _link_parts(
        name, dev, receive, decode, frame_bits, noise_std_fn,
        {"rate": rate, "Es": Es, "bps": bps, "channel_taps": h_np,
         "n_eq_taps": n_eq_taps, "trellis": trellis,
         "decoding_type": "soft"}, (n_sym,))


def make_bch_awgn_link(
    *,
    code,
    modulation_m: int = 2,
    use_psk: bool = True,
    decoder: str = "hard",
    chase_p: int = 4,
    name: str = "bch-awgn",
    device="cuda",
) -> DeviceLink:
    """BCH link over complex AWGN: bits -> systematic BCH -> PSK/QAM ->
    AWGN -> demapping -> BCH decode -> payload bit errors.

    ``decoder='hard'``: minimum-distance demapping and hard decoding;
    ``'chase'``: exact-LLR magnitudes as bit reliabilities into Chase-2
    soft decoding (2^chase_p patterns).  ``receive`` returns the hard
    bits, or the LLRs (positive => bit 1) for Chase.
    """
    if decoder not in ("hard", "chase"):
        raise ValueError(f"decoder must be 'hard' or 'chase', got "
                         f"{decoder!r}")
    dev = resolve_device(device)
    const, Es, bps = _constellation(modulation_m, use_psk)
    if code.n % bps:
        raise ValueError(f"n={code.n} must fill whole {bps}-bit symbols")
    rate = code.k / code.n
    encode = make_bch_encoder(code, dev)
    hard_dec = make_bch_decoder(code, device=dev)
    if decoder == "chase":
        chase = make_bch_chase_decoder(code, p=chase_p, device=dev)

    def receive(bits, noise, noise_std):
        with span("link.encode"):
            cw = encode(bits)
        with span("link.modulate_channel"):
            y = _noisy(M.modulate(cw, const, bps, device=dev), noise,
                       noise_std)
        with span("link.demodulate"):
            if decoder == "chase":
                ns = np.float32(noise_std)
                return M.demodulate_soft(y, const, bps, ns * ns)
            return M.demodulate_hard(y, const, bps)

    def decode(rx):
        with span("link.bch_decode"):
            if decoder == "chase":
                corrected, _, _ = chase((rx > 0).to(torch.int8),
                                        torch.abs(rx))
            else:
                corrected, _, _ = hard_dec(rx)
            return corrected[:, :code.k]

    return _link_parts(
        name, dev, receive, decode, code.k,
        lambda snr_db: snr_to_noise_std(snr_db, code_rate=rate, Es=Es),
        {"rate": rate, "Es": Es, "bps": bps, "decoder": decoder},
        (code.n // bps,))


def make_rs_awgn_link(
    *,
    code,
    modulation_m: Optional[int] = None,
    decoder: str = "hard",
    name: str = "rs-awgn",
    device="cuda",
) -> DeviceLink:
    """Reed-Solomon link over complex AWGN.

    One QAM symbol per RS symbol by default (order 2^m, e.g. 256-QAM for
    GF(2^8)): message bits -> symbols (LSB-first, the codec's order) ->
    RS encode -> QAM -> AWGN -> demapping -> RS decode -> message bits.
    ``decoder='gmd'`` drives GMD soft decoding with each symbol's
    minimum |LLR| as its reliability (designed for informative
    reliabilities; on plain AWGN 'hard' does better).  ``receive``
    returns the hard bits, or the LLRs (positive => bit 1) for GMD.
    """
    if decoder not in ("hard", "gmd"):
        raise ValueError(f"decoder must be 'hard' or 'gmd', got "
                         f"{decoder!r}")
    dev = resolve_device(device)
    m = code.m
    if modulation_m is None:
        modulation_m = 1 << m
    const, Es, bps = _constellation(modulation_m, False)
    if (code.n * m) % bps:
        raise ValueError(
            f"n*m={code.n * m} coded bits must fill whole {bps}-bit "
            f"symbols")
    rate = code.k / code.n
    encode = make_rs_encoder(code, dev)
    hard_dec = make_rs_decoder(code, device=dev)
    if decoder == "gmd":
        gmd = make_rs_gmd_decoder(code, device=dev)

    def receive(bits, noise, noise_std):
        F = bits.shape[0]
        with span("link.encode"):
            msg = _bits_to_sym(on_device(bits, dev).reshape(F, code.k, m),
                               m)
            cw_bits = _sym_to_bits(encode(msg), m).reshape(F, -1)
        with span("link.modulate_channel"):
            y = _noisy(M.modulate(cw_bits.to(torch.int8), const, bps,
                                  device=dev), noise, noise_std)
        with span("link.demodulate"):
            if decoder == "gmd":
                ns = np.float32(noise_std)
                return M.demodulate_soft(y, const, bps, ns * ns)
            return M.demodulate_hard(y, const, bps)

    def decode(rx):
        F = rx.shape[0]
        with span("link.rs_decode"):
            rx_syms = _bits_to_sym((rx > 0).reshape(F, code.n, m), m)
            if decoder == "gmd":
                rel = torch.amin(torch.abs(rx).reshape(F, code.n, m), dim=-1)
                corrected, _, _ = gmd(rx_syms, rel)
            else:
                corrected, _, _ = hard_dec(rx_syms)
            return _sym_to_bits(corrected[:, :code.k], m).reshape(
                F, -1).to(torch.int8)

    return _link_parts(
        name, dev, receive, decode, code.k * m,
        lambda snr_db: snr_to_noise_std(snr_db, code_rate=rate, Es=Es),
        {"rate": rate, "Es": Es, "bps": bps, "decoder": decoder},
        (code.n * m // bps,))


def make_dvbs2_concat_link(
    *,
    qc_params: dict,
    t_bch: int = 12,
    modulation_m: int = 4,
    n_iterations: int = 30,
    name: str = "dvbs2-concat",
    device="cuda",
) -> DeviceLink:
    """The DVB-S2 concatenation: BCH outer code, LDPC inner code.

    payload -> shortened GF(2^16) t-error BCH -> DVB-S2 LDPC
    (:func:`~commpy_tpu_torch.ops.dvbs2.dvbs2_encode_device`) -> PSK ->
    AWGN -> layered MSA BP (``msa_scale=0.75``; the streamed kernel K5 on
    the card) -> bit-sliced BCH hard decode -> payload bit errors.  The
    LDPC convention holds: a positive LLR means bit 0.
    """
    dev = resolve_device(device)
    kldpc = qc_params["k_bits"]
    outer = bch_construct(16, t_bch, shorten=(1 << 16) - 1 - kldpc)
    if outer.n != kldpc:
        raise ValueError(f"the BCH code's n={outer.n} is not the LDPC "
                         f"code's k={kldpc}")
    const, Es, bps = _constellation(modulation_m, True)
    n_ldpc = qc_params["n_vnodes"]
    if n_ldpc % bps:
        raise ValueError(f"n={n_ldpc} must fill whole {bps}-bit symbols")
    rate = outer.k / n_ldpc
    enc_bch = make_bch_encoder(outer, dev)
    dec_bch = make_bch_decoder(outer, device=dev)

    def receive(bits, noise, noise_std):
        with span("link.encode"):
            cw = dvbs2_encode_device(enc_bch(bits), qc_params, device=dev)
        with span("link.modulate_channel"):
            y = _noisy(M.modulate(cw, const, bps, device=dev), noise,
                       noise_std)
        with span("link.demodulate"):
            ns = np.float32(noise_std)
            return -M.demodulate_soft(y, const, bps, ns * ns)

    def decode(llr):
        with span("link.ldpc_decode"):
            dec, _ = dvbs2_decode_device(llr, qc_params, "MSA", n_iterations,
                                         msa_scale=0.75, device=dev)
        with span("link.bch_decode"):
            corrected, _, _ = dec_bch(dec[:, :kldpc].to(torch.int8))
            return corrected[:, :outer.k]

    return _link_parts(
        name, dev, receive, decode, outer.k,
        lambda snr_db: snr_to_noise_std(snr_db, code_rate=rate, Es=Es),
        {"rate": rate, "Es": Es, "bps": bps, "t_bch": t_bch,
         "outer": outer}, (n_ldpc // bps,))


def make_polar_awgn_link(
    *,
    code,
    decoder: str = "scl",
    list_size: int = 8,
    modulation_m: int = 2,
    use_psk: bool = True,
    rule: str = "minsum",
    constellation=None,
    name: str = "polar-awgn",
    device="cuda",
) -> DeviceLink:
    """Polar-coded link over complex AWGN.

    ``code`` is a :class:`~commpy_tpu_torch.ops.polar.PolarCode` (build
    with :func:`~commpy_tpu_torch.ops.polar.polar_construct`; give it a CRC
    for CRC-aided list decoding).  ``decoder``: 'sc' or 'scl'; the list
    decoder is :func:`~commpy_tpu_torch.ops.polar.polar_scl_decode`'s
    route, chosen once here: K7 on a GPU for the codes it takes, else the
    decoder specialised to the frozen mask, and the blocked scan on the
    CPU (the same decisions).  ``constellation`` (points indexed by their
    label, e.g. :func:`~commpy_tpu_torch.ops.modem.nr_qpsk_constellation`)
    replaces ``modulation_m`` / ``use_psk``; Es and the bits a symbol come
    from it.  The LLRs are the negated demapper output (positive => bit
    0), rate-recovered to the mother code.  CRC parity bits count as rate
    overhead in the Eb/N0 accounting (rate = K / E).
    """
    if decoder not in ("sc", "scl"):
        raise ValueError(f"decoder must be 'sc' or 'scl', got {decoder!r}")
    dev = resolve_device(device)
    if constellation is None:
        const, Es, bps = _constellation(modulation_m, use_psk)
    else:
        pts = np.asarray(constellation)
        Es = float(np.mean(np.abs(pts.astype(np.complex128)) ** 2))
        const, bps = pts.astype(np.complex64), int(np.log2(pts.size))
    if code.E % bps:
        raise ValueError(f"E={code.E} must fill whole {bps}-bit symbols")
    rate = code.rate
    encode = P.make_polar_encoder(code, dev)
    if decoder == "sc":
        polar_decode = P.make_polar_sc_decoder(code, rule=rule, device=dev)
    else:
        # the route, planned once (cached)
        polar_decode = P.make_polar_scl_route(code, list_size=list_size,
                                              rule=rule, device=dev)

    def receive(bits, noise, noise_std):
        with span("link.encode"):
            x = P.polar_rate_match(code, encode(bits), device=dev)  # [F, E]
        with span("link.modulate_channel"):
            y = _noisy(M.modulate(x, const, bps, device=dev), noise,
                       noise_std)
        with span("link.demodulate"):
            ns = np.float32(noise_std)
            return P.polar_rate_recover(
                code, -M.demodulate_soft(y, const, bps, ns * ns), device=dev)

    def decode(llr):
        with span("link.polar_decode"):
            return polar_decode(llr)

    return _link_parts(
        name, dev, receive, decode, code.K,
        lambda snr_db: snr_to_noise_std(snr_db, code_rate=rate, Es=Es),
        {"rate": rate, "Es": Es, "bps": bps, "decoder": decoder},
        (code.E // bps,))


def make_idd_kbest_ldpc_mimo_link(
    *,
    ldpc_params: dict,
    nb_tx: int = 4,
    nb_rx: int = 4,
    modulation_m: int = 16,
    beam: int = 16,
    algorithm: str = "MSA",
    n_iterations: int = 15,
    n_it: int = 1,
    damping: float = 1.0,
    llr_clip: float = 50.0,
    name: str = "idd-kbest-ldpc-mimo",
    device="cuda",
) -> DeviceLink:
    """LDPC-coded MIMO link decoded through the device IDD loop.

    The chain of :func:`make_bestfirst_ldpc_mimo_link` with
    ``detector='kbest'``, but the receive side is the iterative
    detection-and-decoding loop of
    :func:`commpy_tpu_torch.models.idd.idd_decoder_device` (the batched
    image of the reference ``idd_decoder`` closure, commpy/links.py:
    345-407): the prior-aware K-best soft detector and the LDPC BP
    posterior exchange extrinsics ``n_it`` times, then a final BP decode
    hard-decides the total LLRs.  A first detection pass with zero priors
    plays the reference's ``received_msg``.  One frame is one codeword;
    the decoder is :func:`~commpy_tpu_torch.ops.ldpc.ldpc_bp_decode_device`,
    which lifts WiMAX to its QC form (K4 on the card, twice a step at
    ``n_it=1``).

    ``damping`` < 1 scales the decoder extrinsic fed back to the
    detector (a decoder wrapper, so the loop itself stays the reference's
    at ``damping=1``).  ``llr_clip`` bounds the detector's max-log LLRs,
    which are +-inf where every survivor agrees on a bit, before any
    extrinsic subtraction.

    ``receive`` returns ``(y [F*n_vec, nr], h [F*n_vec, nr, nt],
    noise_var, a0 [F*n_vec*nt*bps])``, the first pass's LLRs ``a0``;
    ``decode`` runs the loop on them.  ``extras`` holds the loop's
    ``detector``, ``decoder`` and ``decision``.
    """
    dev = resolve_device(device)
    if ldpc_params.get("generator_matrix") is None:
        build_matrix(ldpc_params)
    G = np.asarray(ldpc_params["generator_matrix"].todense()) % 2
    G_dev = torch.as_tensor(G.astype(np.int8), device=dev)
    n_v = ldpc_params["n_vnodes"]
    frame_bits = n_v - ldpc_params["n_cnodes"]
    const, Es, bps = _constellation(modulation_m, False)
    rate = frame_bits / n_v
    n_sym = n_v // bps
    if n_v % bps or n_sym % nb_tx:
        raise ValueError(f"codeword length {n_v} must fill whole {bps}-bit "
                         f"symbols and whole {nb_tx}-symbol vectors")
    n_vec = n_sym // nb_tx

    def detector(yv, hv, noise_var, a_priori):
        return kbest_device(yv, hv, const, int(beam), noise_var, "soft", bps,
                            a_priori=a_priori, llr_clip=float(llr_clip),
                            device=dev)

    def bp(llrs_flat):
        return ldpc_bp_decode_device(llrs_flat.reshape(-1, n_v), ldpc_params,
                                     algorithm, n_iterations, device=dev)

    def soft_decoder(llrs_flat):
        post = bp(llrs_flat)[1].reshape(-1)
        if damping != 1.0:
            # damp the extrinsic the loop derives (post - input):
            # x + d*(post - x) makes a_det_new = d*(post - x)
            post = llrs_flat + damping * (post - llrs_flat)
        return post

    def decision(llrs_flat):
        return bp(llrs_flat)[0][..., :frame_bits]

    idd = idd_decoder_device(detector, soft_decoder, decision, int(n_it))

    def receive(bits, noise, noise_std, h):
        F = bits.shape[0]
        with span("link.encode"):
            coded = ldpc_encode_device(bits, G_dev, device=dev)  # [F, n_v]
        with span("link.modulate_channel"):
            x = M.modulate(coded, const, bps, device=dev).reshape(
                F, n_vec, nb_tx)
            y, h = _mimo_channel(x, h, noise, noise_std)
        with span("link.detect"):
            yv, hv = y.reshape(-1, nb_rx), h.reshape(-1, nb_rx, nb_tx)
            ns = np.float32(noise_std)
            nv = ns * ns
            a0 = detector(yv, hv, nv, torch.zeros(
                (yv.shape[0], nb_tx * bps), dtype=torch.float32, device=dev))
            return yv, hv, nv, a0.reshape(-1)

    def decode(rx):
        with span("link.idd_decode"):
            return idd(*rx)

    def noise_std_fn(snr_db):
        return snr_to_noise_std(snr_db, code_rate=rate, Es=Es, nb_tx=nb_tx)

    return _link_parts(name, dev, receive, decode, frame_bits, noise_std_fn,
                       {"rate": rate, "Es": Es, "bps": bps, "n": n_v,
                        "detector": detector, "decoder": soft_decoder,
                        "decision": decision},
                       (n_vec, nb_rx), (n_vec, nb_rx, nb_tx))
