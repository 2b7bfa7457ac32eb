#!/usr/bin/env python3
"""Drive the commpy_tpu_torch port end to end on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``commpy_tpu_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch version on the card, bit
   for bit: the bench shape (K=7 soft, B=2048, L=1024, tb_depth=30), the
   802.11 MCS-4 shape (B=2048, L=1200) and small odd shapes (S = 2, 4,
   64, 256, 1024; hard, soft and unquantized; B not a multiple of 32),
   where the plain versions also run on the host CPU;
4. runs the main path: the 802.11 MCS-4 link (16-QAM, rate 3/4,
   frame_bits=1200) at F=2048 frames per step at 12 dB through
   ``montecarlo_ber``, plus the physics checks (uncoded QPSK BER against
   erfc, K=7 soft beating that uncoded curve by more than 10x at 2 dB, and
   ``errs(35 dB) == 0 < errs(5 dB)`` at MCS-4); both kernels' launch
   counters must rise during this phase;
5. times each kernel and its plain version with CUDA events, the decoder
   at the bench configuration and the MCS-4 link step.

Exits non-zero, with no result line, when there is no CUDA device or the
port cannot be imported, and on any failed check.  The last line is
``{"ok": true, "device": {...}}``; the line before holds the per-kernel
records, and everything measured is also written to
``build/chip_smoke.json``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SOURCE = "commpy_tpu_torch/kernels/csrc/viterbi_acs.cu"


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def k1_bound(B, T, n, S):
    """Least time of the ACS pass: r read once, decisions and best states
    written once; per state-step two adds, a compare, the renormalising
    subtract and one compare of the minimum, plus the 2^n distinct branch
    metrics of each step."""
    G = -(-S // 32)
    nbytes = 4 * B * T * (n + G + 1)
    ops = B * T * (5 * S + 2 ** n * (2 * n - 1))
    return nbytes, ops


def k2_bound(B, T, S, tb_depth):
    """Least time of the traceback: decisions and best states read once,
    bits written once; four integer operations per back-step."""
    G = -(-S // 32)
    nbytes = B * T * (4 * G + 4 + 1)
    steps = np.minimum(tb_depth - 2, T - 1 - np.arange(T)).clip(min=0)
    ops = 4 * B * int(steps.sum())
    return nbytes, ops


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_input(torch, trellis, decoding_type, B, L, seed, dev):
    """Kernel input r [B, T, n] for a random message through the code, a
    BPSK-like channel and the decoder's own clip and padding."""
    from commpy_tpu_torch.ops.convcode import encode_scan
    from commpy_tpu_torch.ops.viterbi import received_words

    rng = np.random.RandomState(seed)
    msg = rng.randint(0, 2, (B, L))
    coded = encode_scan(msg, trellis, device="cpu")[0].numpy()
    if decoding_type == "hard":
        x = (coded ^ (rng.rand(*coded.shape) < 0.06)).astype(np.float32)
    elif decoding_type == "soft":
        x = (2.0 * coded - 1) * 2 + rng.randn(*coded.shape) * 2.0
    else:
        x = (2.0 * coded - 1) + rng.randn(*coded.shape) * 0.9
    return received_words(torch.as_tensor(x, device=dev), trellis,
                          decoding_type, L)


class Tally:
    """Kernel-versus-plain comparison counts of one kernel."""

    def __init__(self):
        self.compared = 0
        self.mismatches = 0
        self.max_abs_err = 0.0

    def add(self, got, want):
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"shape/type {tuple(got.shape)} {got.dtype} vs "
                 f"{tuple(want.shape)} {want.dtype}")
        diff = (got.long() - want.long()).abs()
        self.compared += got.numel()
        self.mismatches += int((diff != 0).sum())
        if diff.numel():
            self.max_abs_err = max(self.max_abs_err, float(diff.max()))


def compare_case(torch, tallies, trellis, decoding_type, B, L, tb_depth,
                 seed, r=None):
    from commpy_tpu_torch.kernels import viterbi_acs as K
    from commpy_tpu_torch.ops.viterbi import _branch_vectors, _kernel_tables

    dev = torch.device("cuda")
    if r is None:
        r = kernel_input(torch, trellis, decoding_type, B, L, seed, dev)
    C, hc = _kernel_tables(_branch_vectors(trellis, decoding_type), trellis,
                           decoding_type, dev)
    S = trellis.number_states
    dec, best = K.acs_forward(r, C, hc)
    dec_p, best_p = K.acs_forward_plain(r, C, hc)
    torch.cuda.synchronize()
    tallies["acs_forward"].add(dec, dec_p)
    tallies["acs_forward"].add(best, best_p)
    bits = K.traceback(dec, best, S, tb_depth)
    bits_p = K.traceback_plain(dec, best, S, tb_depth)
    torch.cuda.synchronize()
    tallies["traceback"].add(bits, bits_p)
    if B <= 64:
        # the plain versions on the host CPU too: the CPU tests hold them
        # against the JAX package, so this closes the chain to it
        cpu = [x.cpu() if x is not None else None for x in (r, C, hc)]
        dec_c, best_c = K.acs_forward_plain(*cpu)
        tallies["acs_forward"].add(dec.cpu(), dec_c)
        tallies["acs_forward"].add(best.cpu(), best_c)
        tallies["traceback"].add(
            bits.cpu(), K.traceback_plain(dec_c, best_c, S, tb_depth))
    return r, C, hc


def link_words(torch, link, B, snr_db, seed):
    """Decoder input r [B, T, n] of the link's own receive chain (bits,
    noise, map, demap, depuncture) at ``snr_db``."""
    from commpy_tpu_torch.ops.viterbi import received_words

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bits = torch.randint(0, 2, (B, link.frame_bits), generator=g,
                         device=dev, dtype=torch.int8)
    z = torch.randn((2, B, link.n_symbols), generator=g, device=dev)
    rx = link.receive(bits, torch.complex(z[0], z[1]),
                      float(link.noise_std_fn(snr_db)))
    return received_words(rx, link.extras["trellis"],
                          link.extras["decoding_type"], link.frame_bits)


def _device_us(event, name):
    return getattr(event, f"{name}device_time_total",
                   getattr(event, f"{name}cuda_time_total", 0)) or 0


def profile_link_step(torch, link, gen, noise_std, step_s, steps=2):
    """Device time of each kernel and of each ``link.<stage>`` span over
    ``steps`` MCS-4 link steps of 2048 frames (torch.profiler), and the
    device's busy share of the step time measured without the profiler.

    A stage has two readings: ``device_span_ms``, the extent of its span
    on the device's timeline (first kernel start to last kernel end, all
    its kernels included), and ``aten_kernels_ms``, the summed time of
    the kernels the profiler ties to PyTorch operators inside it (it does
    not tie K1 and K2, which are launched through ctypes, to the span)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            link.link_step(gen, 2048, noise_std)
        torch.cuda.synchronize()
    rows, stages = [], {}
    for e in prof.key_averages():
        on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
        if e.key.startswith("link."):
            side = "device_span_ms" if on_device else "aten_kernels_ms"
            stages.setdefault(e.key, {})[side] = (_device_us(e, "") / steps
                                                  / 1e3)
            continue
        us = _device_us(e, "self_")
        if on_device and us > 0:
            rows.append({"kernel": e.key[:120], "ms_per_step":
                         us / steps / 1e3, "calls_per_step": e.count / steps})
    rows.sort(key=lambda row: -row["ms_per_step"])
    busy_ms = sum(row["ms_per_step"] for row in rows)
    out = {"device_busy_ms_per_step": busy_ms,
           "step_ms": step_s * 1e3,
           "device_idle_share": (1 - busy_ms / (step_s * 1e3)
                                 if busy_ms else "not measured"),
           "stages_device_ms_per_step": stages,
           "kernels": rows[:25]}
    top = ", ".join(f"{row['kernel'][:40]} {row['ms_per_step']:.3f}"
                    for row in rows[:6])
    split = ", ".join(f"{k} {v.get('device_span_ms', float('nan')):.3f}"
                      for k, v in stages.items())
    print(f"MCS-4 link step profile: device busy {busy_ms:.3f} ms of "
          f"{step_s * 1e3:.3f} ms; stages (device span ms): {split}; top "
          f"kernels: {top}", flush=True)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from commpy_tpu_torch.kernels import _build
        from commpy_tpu_torch.kernels import viterbi_acs as K
        from commpy_tpu_torch.models import wifi80211_device_link
        from commpy_tpu_torch.models.device_links import make_conv_awgn_link
        from commpy_tpu_torch.ops import modem as M
        from commpy_tpu_torch.ops.channel import snr_to_noise_std
        from commpy_tpu_torch.ops.trellis import Trellis
        from commpy_tpu_torch.ops.viterbi import (received_words,
                                                  viterbi_decode_device)
        from commpy_tpu_torch.parallel import montecarlo_ber
    except ImportError as e:
        print(f"chip_smoke: the commpy_tpu_torch port is not importable "
              f"here ({e})", file=sys.stderr)
        return 2
    from scipy.special import erfc

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # ---- build ------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build()
    report["build_s"] = time.perf_counter() - t0
    for name, path in paths.items():
        log = path.with_suffix(".log")
        if log.exists():
            print(f"[build {name}]\n{log.read_text()}", file=sys.stderr)
    print(f"built {sorted(paths)} in {report['build_s']:.1f} s", flush=True)

    # ---- kernels against their plain versions ------------------------
    tallies = {"acs_forward": Tally(), "traceback": Tally()}
    k7 = Trellis(np.array([6]), np.array([[0o133, 0o171]]))
    small = [
        (Trellis(np.array([1]), np.array([[3, 1]])), "hard", 7, 50, 5),
        (Trellis(np.array([2]), np.array([[5, 7]])), "hard", 37, 211, 15),
        (Trellis(np.array([2]), np.array([[5, 7]])), "soft", 37, 211, 15),
        (Trellis(np.array([2]), np.array([[5, 7]])), "unquantized", 37, 211,
         15),
        (k7, "hard", 45, 300, 30),
        (k7, "soft", 45, 300, 30),
        (k7, "unquantized", 45, 300, 30),
        (k7, "soft", 3, 100, 2),
        (k7, "soft", 3, 100, 500),
        (Trellis(np.array([8]), np.array([[0o561, 0o753]])), "hard", 33, 250,
         40),
        (Trellis(np.array([8]), np.array([[0o561, 0o753]])), "soft", 33, 250,
         40),
        (Trellis(np.array([8]), np.array([[0o561, 0o753]])), "unquantized",
         33, 250, 40),
        (Trellis(np.array([10]), np.array([[0o2335, 0o3661]])), "soft", 5,
         120, 50),
        # the traceback's decisions past 48 KB of shared memory (the
        # opt-in) and past its 200 KB staging limit (read from global)
        (Trellis(np.array([10]), np.array([[0o2335, 0o3661]])), "soft", 3,
         500, 60),
        (Trellis(np.array([10]), np.array([[0o2335, 0o3661]])), "hard", 3,
         2000, 100),
    ]
    for i, (tr, dt, B, L, tb) in enumerate(small):
        compare_case(torch, tallies, tr, dt, B, L, tb, seed=100 + i)
    # bench shape: bench.py's input, randn * 3 LLRs
    rng = np.random.RandomState(0)
    bench_llr = torch.as_tensor(
        rng.randn(2048, 2 * 1024).astype(np.float32) * 3, device=dev)
    r_bench = received_words(bench_llr, k7, "soft", 1024)
    _, C7, _ = compare_case(torch, tallies, k7, "soft", 2048, 1024, 30, 0,
                            r=r_bench)
    # MCS-4 shape: LLRs from the link's own receive chain at 12 dB
    link = wifi80211_device_link(4, frame_bits=1200, device="cuda")
    r_mcs4 = link_words(torch, link, 2048, 12.0, 7)
    compare_case(torch, tallies, k7, "soft", 2048, 1200, 30, 0, r=r_mcs4)
    # the whole decoder: kernels against the plain path
    full_auto = viterbi_decode_device(bench_llr, k7, 30, "soft", L=1024)
    full_plain = viterbi_decode_device(bench_llr, k7, 30, "soft", L=1024,
                                       backend="torch")
    torch.cuda.synchronize()
    decoder_mismatch = int((full_auto != full_plain).sum())
    for name, tally in tallies.items():
        print(f"{name}: {tally.mismatches} mismatches in {tally.compared} "
              f"values", flush=True)
        if tally.mismatches:
            fail(f"{name} disagrees with its plain version")
    if decoder_mismatch:
        fail(f"decoder: {decoder_mismatch} bits differ between the kernels "
             f"and the plain path")

    # ---- the main path ------------------------------------------------
    K.acs_forward.launches = 0
    K.traceback.launches = 0
    res = montecarlo_ber(link.link_step, [12.0], link.noise_std_fn,
                         link.frame_bits, seed=1, frames_per_round=2048,
                         max_rounds=3, err_min=10 ** 9, device="cuda")
    main_launches = {"acs_forward": K.acs_forward.launches,
                     "traceback": K.traceback.launches}
    report["mcs4_12db"] = {"bit_errors": res.bit_errors.tolist(),
                           "bits_sent": res.bits_sent.tolist(),
                           "ber": res.bers.tolist(), "rounds": res.rounds}
    print(f"main path MCS-4 F=2048 at 12 dB: {res.rounds} steps, BER "
          f"{res.bers[0]:.3e}; launches {main_launches}", flush=True)
    if res.rounds != 3 or res.bits_sent[0] != 3 * 2048 * 1200:
        fail(f"main path ran {res.rounds} rounds")
    # 12 dB sits on the MCS-4 waterfall: errors, but far fewer than half
    if not np.isfinite(res.bers).all() or not 0 < res.bers[0] < 0.1:
        fail(f"MCS-4 BER at 12 dB is {res.bers[0]}")
    for name, count in main_launches.items():
        if count == 0:
            fail(f"the main path never launched {name}")

    # physics checks
    qpsk = M.qam_constellation(4).astype(np.complex64)

    def uncoded_step(gen, frames, noise_std):
        bits = torch.randint(0, 2, (frames, 1000), generator=gen, device=dev,
                             dtype=torch.int8)
        z = torch.randn((2, frames, 500), generator=gen, device=dev)
        y = M.modulate(bits, qpsk, 2) + torch.complex(z[0], z[1]) * (
            noise_std * 0.5)
        return torch.sum(M.demodulate_hard(y, qpsk, 2) ^ bits,
                         dtype=torch.int32)

    snrs = np.arange(0, 9, 2.0)
    unc = montecarlo_ber(uncoded_step, snrs,
                         lambda s: snr_to_noise_std(s, Es=2.0), 1000, seed=2,
                         frames_per_round=256, max_rounds=20, err_min=400,
                         device="cuda")
    theory = erfc(np.sqrt(10 ** (snrs / 10) / 2)) / 2
    print(f"uncoded QPSK BER {unc.bers.tolist()} theory {theory.tolist()}",
          flush=True)
    if not np.allclose(unc.bers, theory, rtol=0.25):
        fail("uncoded QPSK BER does not match erfc")
    coded = make_conv_awgn_link(trellis=k7, modulation_m=2, frame_bits=1000,
                                decoding_type="soft", device="cuda")
    cod = montecarlo_ber(coded.link_step, [2.0], coded.noise_std_fn, 1000,
                         seed=3, frames_per_round=512, max_rounds=8,
                         err_min=200, device="cuda")
    # the uncoded QPSK curve of the sweep above, at 2 dB
    uncoded_2db = erfc(np.sqrt(10 ** 0.2 / 2)) / 2
    print(f"K=7 soft BER at 2 dB {cod.bers[0]:.3e} ({cod.bit_errors[0]:.0f} "
          f"errors) vs uncoded {uncoded_2db:.3e}", flush=True)
    if not (cod.bit_errors[0] > 0 and cod.bers[0] * 10 < uncoded_2db):
        fail("K=7 soft decoding does not beat uncoded QPSK by 10x at 2 dB")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    e35 = int(link.link_step(gen, 256, float(link.noise_std_fn(35.0))))
    e5 = int(link.link_step(gen, 256, float(link.noise_std_fn(5.0))))
    print(f"MCS-4 errors: {e35} at 35 dB, {e5} at 5 dB", flush=True)
    if not e35 == 0 < e5:
        fail("MCS-4 link fails errs(35 dB) == 0 < errs(5 dB)")
    report["physics"] = {
        "uncoded_qpsk_ber": unc.bers.tolist(), "theory": theory.tolist(),
        "k7_soft_2db_ber": float(cod.bers[0]),
        "uncoded_2db": float(uncoded_2db),
        "mcs4_errs_35db": e35, "mcs4_errs_5db": e5}

    # ---- timing -------------------------------------------------------
    timings = {}
    for shape, r in (("mcs4", r_mcs4), ("bench", r_bench)):
        B, T, n = r.shape
        dec, best = K.acs_forward(r, C7)
        torch.cuda.synchronize()
        timings[shape] = {
            "B": B, "T": T,
            "acs_ms": cuda_ms(torch, lambda: K.acs_forward(r, C7), 10),
            "acs_plain_ms": cuda_ms(
                torch, lambda: K.acs_forward_plain(r, C7), 2),
            "tb_ms": cuda_ms(torch, lambda: K.traceback(dec, best, 64, 30),
                             20),
            "tb_plain_ms": cuda_ms(
                torch, lambda: K.traceback_plain(dec, best, 64, 30), 3),
            "acs_bound": k1_bound(B, T, n, 64),
            "tb_bound": k2_bound(B, T, 64, 30),
        }
    dec_ms = cuda_ms(torch, lambda: viterbi_decode_device(
        bench_llr, k7, 30, "soft", L=1024), 10)
    decoded_bps = 2048 * 1024 / (dec_ms * 1e-3)
    ns = float(link.noise_std_fn(12.0))
    gen.manual_seed(5)
    link.link_step(gen, 2048, ns)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        link.link_step(gen, 2048, ns)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    link_bps = 2048 * 1200 / step_s
    report["mcs4_link_profile"] = profile_link_step(torch, link, gen, ns,
                                                    step_s)
    report["timings"] = timings
    report["decoder_bench_ms"] = dec_ms
    report["decoded_info_bits_per_s"] = decoded_bps
    report["mcs4_link_step_s"] = step_s
    report["mcs4_link_info_bits_per_s"] = link_bps

    kernels = []
    for name, key, replaces in (
            ("acs_forward", "acs",
             "commpy_tpu/kernels/viterbi_acs.py:232"),
            ("traceback", "tb", "commpy_tpu/kernels/viterbi_acs.py:505")):
        m4, bn = timings["mcs4"], timings["bench"]
        b_ms, b_by = bound_ms(*m4[f"{key}_bound"])
        bb_ms, _ = bound_ms(*bn[f"{key}_bound"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": main_launches[name],
            "mismatches": tallies[name].mismatches,
            "compared": tallies[name].compared,
            "max_abs_err": tallies[name].max_abs_err,
            "ms": m4[f"{key}_ms"], "kernel_ms": m4[f"{key}_ms"],
            "plain_ms": m4[f"{key}_plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": f"B=2048 T={m4['T']} S=64 (MCS-4)",
            "bench_ms": bn[f"{key}_ms"], "bench_plain_ms":
                bn[f"{key}_plain_ms"], "bench_bound_ms": bb_ms,
        })
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    print(json.dumps({
        "decoded_info_bits_per_s": decoded_bps,
        "decoder_config": "K=7 soft, B=2048, L=1024, tb_depth=30",
        "mcs4_link_info_bits_per_s": link_bps,
        "link_config": "802.11 MCS-4, frame_bits=1200, F=2048, 12 dB",
        "card": card, "seconds": report["seconds"]}), flush=True)
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
