"""Batched end-to-end link pipelines.

Counterpart of the conv-coded part of ``commpy_tpu/models/device_links.py``.
``make_conv_awgn_link`` returns a :class:`DeviceLink` whose
``link_step(generator, n_frames, noise_std) -> bit_errors`` simulates a
batch of frames on one device: random bits -> FEC encode -> map ->
channel -> demap -> decode -> XOR count.  The random draws and the
deterministic chain are separate: ``transceive(bits, noise, noise_std)``
takes the bits and the unit complex noise as inputs, so tests can feed the
JAX package and the port the same draws; it is ``decode(receive(...))``,
where ``receive`` ends with the decoder's input.  Each stage runs under a
``torch.profiler.record_function`` span named ``link.<stage>``, so a
profile assigns device time by stage.

Conventions follow the reference link stack: SNR_dB = (Eb/N0)_dB +
10 log10(Rc * Mc); complex AWGN noise ``(re + 1j*im) * noise_std * 0.5``;
soft Viterbi consumes LLRs with positive => bit 1; LDPC BP consumes
``llr = -demodulate_soft(...)``, positive => bit 0 (signbit decisions).
The turbo link is real BPSK over real AWGN, ``tx + noise * noise_std``.
The MIMO and OFDM links are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import modem as M
from ..ops.channel import snr_to_noise_std
from ..ops.convcode import depuncture_device, encode_scan, puncture_mask
from ..ops.ldpc import build_matrix, ldpc_bp_decode_device, ldpc_encode_device
from ..ops.qcldpc import qc_bp_decode_device, qc_encoder
from ..ops.scramble import descramble, scramble
from ..ops.trellis import Trellis
from ..ops.turbo import turbo_decode_device, turbo_encode_device
from ..ops.viterbi import viterbi_decode_device
from ..utils.device import device_constant, on_device, resolve_device

__all__ = ["DeviceLink", "make_conv_awgn_link", "make_turbo_awgn_link",
           "make_qcldpc_awgn_link", "make_ldpc_rayleigh_link"]


@dataclass
class DeviceLink:
    """A batched link simulation on one device.

    link_step : ``(generator, n_frames, noise_std) -> bit errors`` (int32
        scalar tensor on ``device``); draws its bits and noise from the
        ``torch.Generator`` it is given.
    transceive : ``(bits [F, frame_bits] int8, noise [F, n_symbols]
        complex64, noise_std) -> decoded bits [F, frame_bits] int8``; the
        deterministic part of ``link_step`` (a fading link also takes its
        channel gains ``h [F, n_symbols]`` complex64).  The turbo link's
        noise is real: ``[F, frame_bits, 3]`` float32 (systematic and two
        parity streams), and ``n_symbols`` counts its values.
    receive : same arguments as ``transceive``; returns the decoder's
        input (depunctured LLRs, hard bits or reals) ``[F, n_coded]``; the
        turbo link's is the received reals ``[F, frame_bits, 3]``.
    decode : ``receive``'s output -> decoded bits ``[F, frame_bits]``; the
        turbo link's also takes ``noise_std``.
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


def _gen_bits(generator: torch.Generator, n_frames: int, n_bits: int,
              device) -> torch.Tensor:
    """Uniform random bits ``[F, n_bits]`` int8."""
    return torch.randint(0, 2, (n_frames, n_bits), generator=generator,
                         device=device, dtype=torch.int8)


def _frame_crandn(generator: torch.Generator, n_frames: int, n: int,
                  device) -> torch.Tensor:
    """Complex normals ``[F, n]`` with unit-variance real and imaginary
    parts (``re + 1j*im``, as the JAX package draws them)."""
    z = torch.randn((2, n_frames, n), generator=generator, device=device)
    return torch.complex(z[0], z[1])


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
        with record_function("link.encode"):
            tx = (bits if scramble_seed is None
                  else scramble(bits, scramble_seed, device=dev))
            coded, _ = encode_scan(tx, trellis, device=dev)  # [F, n_coded]
            if keep is not None:
                coded = coded[:, keep_idx]
        with record_function("link.modulate_channel"):
            symbols = M.modulate(coded, const, bps, device=dev)  # [F, n_sym]
            ns = np.float32(noise_std)
            y = symbols + on_device(noise, dev) * float(ns * np.float32(0.5))
        with record_function("link.demodulate"):
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
        with record_function("link.viterbi"):
            dec = viterbi_decode_device(rx, trellis, tb_depth, decoding_type,
                                        L=frame_bits, device=dev)
            if scramble_seed is not None:
                dec = descramble(dec, scramble_seed, device=dev)
        return dec

    def transceive(bits, noise, noise_std):
        return decode(receive(bits, noise, noise_std))

    def link_step(generator, n_frames, noise_std):
        bits = _gen_bits(generator, n_frames, frame_bits, dev)
        noise = _frame_crandn(generator, n_frames, n_sym, dev)
        dec = transceive(bits, noise, noise_std)
        with record_function("link.count_errors"):
            return torch.sum(torch.bitwise_xor(dec, bits), dtype=torch.int32)

    def noise_std_fn(snr_db):
        return snr_to_noise_std(snr_db, code_rate=rate, Es=Es)

    return DeviceLink(link_step, frame_bits, noise_std_fn, name,
                      {"rate": rate, "Es": Es, "bps": bps,
                       "trellis": trellis, "decoding_type": decoding_type},
                      transceive,
                      n_sym, receive, decode)


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
        with record_function("link.encode"):
            sys_b, par1_b, par2_b = turbo_encode_device(
                bits, trellis, trellis, p_array, device=dev)
            tx = 2.0 * torch.stack([sys_b, par1_b, par2_b], -1).to(
                torch.float32) - 1.0  # [F, L, 3]
        with record_function("link.modulate_channel"):
            return tx + on_device(noise, dev) * float(np.float32(noise_std))

    def decode(y, noise_std):
        with record_function("link.turbo_decode"):
            ns = np.float32(noise_std)
            return turbo_decode_device(
                y[..., 0], y[..., 1], y[..., 2], trellis, ns * ns,
                n_iterations, p_array, window=window,
                window_init=window_init, kernel_io=kernel_io, device=dev)

    def transceive(bits, noise, noise_std):
        return decode(receive(bits, noise, noise_std), noise_std)

    def link_step(generator, n_frames, noise_std):
        bits = _gen_bits(generator, n_frames, frame_bits, dev)
        noise = torch.randn((n_frames, frame_bits, 3), generator=generator,
                            device=dev)
        dec = transceive(bits, noise, noise_std)
        with record_function("link.count_errors"):
            return torch.sum(torch.bitwise_xor(dec, bits), dtype=torch.int32)

    def noise_std_fn(snr_db):
        # real channel: noise_std = sqrt(Es / (rate * snr))
        return snr_to_noise_std(snr_db, code_rate=rate, Es=1.0,
                                is_complex=False)

    return DeviceLink(link_step, frame_bits, noise_std_fn, name,
                      {"rate": rate}, transceive, 3 * frame_bits, receive,
                      decode)


def _ldpc_link_parts(name, dev, receive, decode, frame_bits, n_sym, rate,
                     Es, extras, fading=False):
    """The ``DeviceLink`` of an LDPC-coded link from its two stages."""

    def transceive(bits, noise, noise_std, *h):
        return decode(receive(bits, noise, noise_std, *h))

    def link_step(generator, n_frames, noise_std):
        bits = _gen_bits(generator, n_frames, frame_bits, dev)
        noise = _frame_crandn(generator, n_frames, n_sym, dev)
        h = ((_frame_crandn(generator, n_frames, n_sym, dev)
              * float(np.sqrt(np.float32(0.5))),) if fading else ())
        dec = transceive(bits, noise, noise_std, *h)
        with record_function("link.count_errors"):
            return torch.sum(torch.bitwise_xor(dec, bits), dtype=torch.int32)

    def noise_std_fn(snr_db):
        return snr_to_noise_std(snr_db, code_rate=rate, Es=Es)

    return DeviceLink(link_step, frame_bits, noise_std_fn, name,
                      dict(extras, rate=rate, Es=Es), transceive, n_sym,
                      receive, decode)


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
    name: str = "qcldpc-awgn",
    device="cuda",
) -> DeviceLink:
    """QC-LDPC-coded QAM/PSK link over complex AWGN.

    One frame is one QC codeword, decoded by
    :func:`~commpy_tpu_torch.ops.qcldpc.qc_bp_decode_device` (flooding,
    ``backend='auto'``: the resident kernel K4 on the card for every
    802.11n code).
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
        with record_function("link.encode"):
            coded = encode(on_device(bits, dev))  # [F, n_v]
        with record_function("link.modulate_channel"):
            ns = np.float32(noise_std)
            y = (M.modulate(coded, const, bps, device=dev)
                 + on_device(noise, dev) * float(ns * np.float32(0.5)))
        with record_function("link.demodulate"):
            return -M.demodulate_soft(y, const, bps, ns * ns)

    def decode(llr):
        with record_function("link.ldpc_decode"):
            dec, _ = qc_bp_decode_device(llr, qc_params, algorithm,
                                         n_iterations, msa_scale=msa_scale,
                                         msa_offset=msa_offset, device=dev)
            return dec[..., :frame_bits]

    return _ldpc_link_parts(name, dev, receive, decode, frame_bits,
                            n_v // bps, frame_bits / n_v, Es, {"n": n_v})


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
        with record_function("link.encode"):
            coded = ldpc_encode_device(bits, G_dev, device=dev)  # [F, n_v]
        with record_function("link.modulate_channel"):
            symbols = M.modulate(coded, const, bps, device=dev)
            ns = np.float32(noise_std)
            gain = on_device(h[0], dev) if fading else torch.ones_like(
                symbols)
            y = gain * symbols + on_device(noise, dev) * float(
                ns * np.float32(0.5))
        with record_function("link.demodulate"):
            # perfect-CSI equalisation; effective per-symbol noise variance
            z = y / gain
            nv = torch.full((), float(ns * ns), dtype=torch.float32,
                            device=dev)
            nv_eff = nv / torch.clamp_min(torch.abs(gain) ** 2, 1e-12)
            return -M.demodulate_soft(z, const, bps, nv_eff)

    def decode(llr):
        with record_function("link.ldpc_decode"):
            dec, _ = ldpc_bp_decode_device(llr, ldpc_params, algorithm,
                                           n_iterations, device=dev)
            return dec[..., :frame_bits]

    return _ldpc_link_parts(name, dev, receive, decode, frame_bits,
                            n_v // bps, frame_bits / n_v, Es, {"n": n_v},
                            fading=fading)
