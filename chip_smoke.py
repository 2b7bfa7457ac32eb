#!/usr/bin/env python3
"""Drive the commpy_tpu_torch port end to end on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``commpy_tpu_torch/kernels/csrc``, then
   holds K6, the joint demapper, against its plain version bit for bit
   (16-QAM at the benchmark cells' shapes, 15M symbols, exact and
   max-log; every order it takes, scalar and per-symbol noise variances,
   far-out symbols) and times it beside its bound, the plain version and
   the per-axis path (``k6_phase``);
3. holds each kernel against its plain PyTorch version on the card, bit
   for bit: the bench shape (K=7 soft, B=2048, L=1024, tb_depth=30), the
   802.11 MCS-4 shape (B=2048, L=1200) and small odd shapes (S = 2, 4, 8,
   16, 32 and 64 on the ACS kernel's warp layout, 128, 256 and 1024 on its
   block layout; n = 1, 2, 3 and 8; hard, soft and unquantized; B not a
   multiple of the frames a warp, T not a multiple of 32), received words
   all zero (every step a tie) and with -0.0 entries, where the plain
   versions also run on the host CPU; the traceback K2 also with
   tb_depth past T, 3 and below 32, and on decisions of random words and
   all ties at S = 2 to 1024, staged in shared memory and read from
   device memory; prints the registers, stack and spills of every kernel
   from ``-Xptxas -v``;
4. runs the main path: the 802.11 MCS-4 link (16-QAM, rate 3/4,
   frame_bits=1200) at F=2048 frames per step at 12 dB through
   ``montecarlo_ber``, plus the physics checks (uncoded QPSK BER against
   erfc, K=7 soft beating that uncoded curve by more than 10x at 2 dB, and
   ``errs(35 dB) == 0 < errs(5 dB)`` at MCS-4); K1's, K2's and K6's
   launch counters must rise during this phase.  From here on every path
   counts K6's launches (``K6Watch``): the soft-demapping ones (MCS-4, A,
   D-G, H-L, M, O, P) must launch it, and on every path a joint-path call
   on the card that reaches the plain demapper where K6 should have run
   fails the script;
5. holds the QC-LDPC kernels against their plain versions: the resident
   kernel K4 on all twelve 802.11n codes and WiMAX 1440 (lifted to QC
   form), MSA and SPA, flooding and layered, msa_scale=0.75, B = 1, 3,
   37, 397 and 512 with clean lanes, +-0.0 LLRs and lanes that converge
   at different iterations, and two synthetic codes whose checks or
   circulant positions exceed a block's threads (each thread loops); the
   streamed layered kernel K5 on the
   DVB-S2-class (16200, 7200) code with its wrap-edge pos_masks, NR BG1
   at Z=208 (rows of up to 24 blocks) and the 802.11n 648 code, B = 1,
   3, 37, 397 (no multiple of the frames in flight) and 512, and two
   synthetic codes (a column repeated within a row; a single row),
   float32 and bfloat16 message stores.  MSA must match bit for bit
   (decisions and posteriors); SPA must give identical decisions and
   posteriors within rtol = atol = 1e-4.  For MSA at small B the plain
   versions also run on the host CPU;
6. Path A: the 802.11n LDPC link (1944, rate 1/2, 16-QAM, MSA 15) at
   F=512 frames per step at 10 dB through ``montecarlo_ber``, with K4's
   and K6's launch counters rising, and its physics checks (1944 BPSK at Eb/N0
   2.5 dB with SPA-30 under BER 1e-3, layered-8 errors <= flooding-15
   errors, ``errs(35 dB) == 0 < errs(5 dB)`` on the 16-QAM link);
7. Path B: ``dvbs2_decode_device`` on the DVB-S2-class code and the NR
   BG1 Z=208 code, layered 8, B=512, float32 and bfloat16 stores:
   noiseless input decodes to itself, noisy input beats the channel's
   hard decisions, K5's launch counter rises;
8. holds the BCJR kernel K3 against its plain version, bit for bit (a
   log-MAP value may differ only within the fallback limit of
   ``K3Tally``): RSC codes of S = 2, 4, 8 and 16 states and a relabelled
   8-state code, log-MAP, max-log and linear, the plain, masked and
   boundary variants, f32 and bf16 io, combined and posterior on and off,
   T = 1, 2 and 3, odd T and R not a multiple of 32 (the plain version
   also on the host CPU for max-log and linear), both history placements
   (shared and device memory) where they fit, S = 16 at T = 320 (device
   memory), and the three bench shapes; and with ``renorm_every`` 1, 2
   and 4 (S = 2 to 16, masked and boundary, T = 1, 3 and 33, both history
   placements), every value bit for bit, log-MAP included;
9. Path C: the rate-1/3 turbo link (LTE's L=6144, 4-state RSC,
   ``RandInterlv(6144, 0)``, 8 iterations, NII windows (128, 0)) at F=256
   frames per step at Eb/N0 1.0 dB through ``montecarlo_ber``, with K3's
   launch counter rising by 16 a step and BER under 1e-2; its physics
   checks (``errs(35 dB) == 0 < errs(-5 dB)``; at L=6144, B=256, 8
   iterations whole-frame, ``window=(256, 32)`` and NII each under BER
   1e-4 at Eb/N0 2.0 dB and over 1e-2 at -1 dB, NII bf16 under 1e-4 at
   2.0 dB, all with their BER at 1.5 dB reported; max-log with
   ``ext_scale=0.7`` beating 1.0 at 0 dB);
10. times each kernel and its plain version with CUDA events (the Viterbi
   decoder at the bench configuration and the MCS-4 link step; K1 and K2
   at the MCS-4 and bench shapes, also by device time, with K2's launch
   plan and back-steps a frame beside those of full walks and of a
   merge-aware walk (``traceback_merge_plain``); K4 at B=512
   MSA-15 flooding and layered-8, also after 0, 1 and 2 sweeps; K5 at
   B=512 layered-8, float32 and bfloat16; K3 at its three bench shapes),
   K4's, K5's and K3's device time with torch.profiler beside it (K5 at
   1, 2 and 3 frames
   per SM and after 0, 1 and 2 sweeps, and on NR BG1 Z=384, held to its
   plain version there, at the plan's grid and at one whose stores fit
   the L2; K3 with each history placement), Path B's noisy
   decodes end to end (info bits/s, K5's sweeps, its time and bound),
   the turbo decoder at the JAX bench's configurations, and the Path A
   and Path C link steps, with their profiles.

11. (run between 9 and 10) Paths D-G, each through ``montecarlo_ber`` with the kernel counts
   set to 0 just before and read just after, then timed and profiled
   (step time, info bits/s, device busy share, top device operations,
   the kernels the step launched): D, the uncoded K-best(16) 4x4 16-QAM
   link at F=2048 (65,536 vectors a step), BER at 16.02 dB within rtol
   1.25 of the reference's 3e-2 and no error at 60 dB, and the K-best
   search on the card against its plain version on the host on the same
   draws, and 2x2 ML on their first two antennas (at most 1e-4 of vectors
   differing); E, best-first(32) detection
   with WiMAX LDPC (1440, 720) MSA-15 on K4 at F=512, BER at 17/18/19 dB
   within rtol 2 of (1.7e-1, 1e-1, 2.5e-3) and at most 1.5x each, K-best(16)
   soft detection under 2e-2 at 21 dB; F, BASELINE configuration 5 (OFDM,
   2x2 16-QAM K-best(8), K=7 soft Viterbi on K1 and K2) at F=2048, under
   1% errors at 35 dB and more at 5 dB; G, the 802.11n (1944, 1/2) 16-QAM
   OFDM-LDPC link over a 4-tap Rayleigh channel at F=512, every CSI mode
   clean at 35 dB, smoothed CSI no worse than LS at 13 dB on the same
   draws, blind CP CFO sync a hundred times better than no correction at
   the JAX package's own configuration (648, QPSK, CFO 0.31) and ten
   times better at 1944 (the estimator's floor under multipath is
   reported beside it, with no CFO);
   K4 on E's and G's own LLRs and K1, K2 on F's (with their +-inf values)
   against their plain versions, bit for bit; then 'auto' decoding of a
   K=12 code and a 32-state turbo code (the general and torch routes)
   against the plain routes, with ``backend='cuda'`` raising;
12. (run after 11) Paths H-L, each link through ``montecarlo_ber`` with
   the kernel counts set to 0 just before and read just after, then timed
   and profiled: H, the RRC pulse-shaped 16-QAM K=7 link (sps 4, span 8,
   alpha 0.35, max-log) at F=2048, no error at 35 dB and errors at 5 dB,
   and with exact LLRs its errors within 1.5x of the symbol-rate link's
   at the highest of 8-12 dB where both count 1000; I, the ISI link
   (channel H3, 21-tap MMSE, QPSK, K=7) at F=2048, no error at 35 dB,
   errors at 2 dB and at 8 dB a tenth of a one-tap receiver's; K1 and K2
   on H's and I's own LLRs against their plain versions; the equalizer at
   the JAX bench's shape (B=256, n=4096, Lh=5, T=31, per-batch taps); J,
   the DVB-S2-class BCH (16200, t=12) decoder on 256 words of 12 errors
   (all corrected), the (31,21) BCH link hard against Chase-4 at 4 dB
   (hard errors more than three times Chase's, Chase's not 0) and the
   (31,21)^2 product code at B=64 (the card's first 4 frames decoded as
   the host decodes them); K, RS(255,223) on 2048 words of 16 symbol
   errors (all corrected) and the RS(204,188) 256-QAM link, hard and GMD,
   clean at 40 dB and erring at 15 dB; L, the DVB-S2 BCH (t=12) + LDPC
   (16200, 1/2) QPSK MSA-30 concatenation at F=512, clean at 5 dB and
   erring at 1 dB, K5 on a step's own LLRs at 5 and 1 dB against its
   plain version bit for bit, and the LDPC and BCH stages timed apart;
13. (run after 12) Paths M-O: M, the polar (1024, 512) CRC-11 QPSK
   SCL-8 link (the decoder specialised to the frozen mask) at F=512
   through ``montecarlo_ber`` at Eb/N0 2 dB, clean at 6 dB, erring at
   -1 dB, with fewer frame errors than SC on the plain code on the same
   draws at 2 dB, one-path SCL (scan and unrolled) decoding as SC, the SC
   (B=2048), scan SCL-8 (B=256) and unrolled SCL-8 (B=1024) decoders at
   the JAX bench's batches (CUDA events), each decoding a B=16 batch on
   the card as on the host (every output); N, the IDD K-best(16) WiMAX
   (1440, 720) MSA-15 link (one exchange) at F=512, its BER at 17/18/19
   dB within rtol 2 of (1.7e-1, 1e-1, 2.5e-3) and at most 1.5x each, K4
   launched twice a step and held to its plain version on the LLRs the
   loop hands its decoder and its decision; O, the CommPy-compatible API:
   ``Wifi80211(4).link_performance`` over a ``SISOFlatChannel`` at 12 dB
   (K1/K2 counted) within 25% of the batched MCS-4 link's BER at the same
   noise_std, one ``channelcoding.turbo_decode`` (K3) equal to the torch
   route's bits, ``LinkModel.link_performance_device`` for uncoded QPSK
   within rtol 0.25 of erfc, and the host loops' time a chunk;
   each link timed and profiled;
14. (run after 13) Paths P-R, at world size 1 over NCCL
   (``make_mesh()``), each with the kernel counts set to 0 just before
   and read just after: P, ``montecarlo_ber`` with ``mesh=`` on the
   MCS-4 link at F=2048, 12 dB, its tallies equal to the main path's and
   each round's to the mesh-less round's, exactly, and the physics checks
   above through the mesh, ``LinkModel.link_performance_device(mesh=)``
   equal to ``mesh=None``; Q, the sequence-parallel Viterbi stream (2^20
   info bits, K=7 soft BPSK, Eb/N0 3 dB, tb_depth 30, warmup 128) equal to
   ``viterbi_decode_device`` on its window and ten times under uncoded
   BPSK, K1 and K2 held to their plain versions on a 4,096-bit stream, and
   the turbo stream (L=6144, 4-state RSC, 8 iterations, Eb/N0 2 dB, 8
   frames) in both ``boundary_init`` modes under BER 1e-4, K3 (which the
   stream runs renormalising every step) held to its plain version
   bit for bit on every MAP pass of one decode in each mode, and each
   pass within 1e-5 (1 + |x|) and 4 eps Gamma of ``_bcjr_masked``, no
   sign flip past either; R, the edge-sharded LDPC
   decoder on Path A's LLRs (802.11n 1944, B=512, MSA-15) equal to the
   dense decode, the Z-sharded DVB-S2-class decoder (B=512, MSA
   flooding-15) equal to the plain flooding core, the sharded FIR on 2^22
   samples with Path H's RRC taps within 1e-5 of ``fir_filter``, and a
   one-stage ``pipeline_map`` of four link stages equal to their serial
   composition; each timed and profiled;
15. (run after 14) the examples: each ``examples/torch`` script's
   ``main(device="cuda")`` at its default size, the kernel counts set to
   0 just before and read just after, its wall time, the checks of
   ``tests/test_torch_examples.py`` (the scripts of NumPy draws against
   the same script on the host), and one K1/K2 call and two K3 calls
   (the turbo decoder's and the renormalising stream's) recorded from
   the scripts held to their plain versions; all five kernels must be
   launched;

With ``--ab DIR`` (a checkout of another commit, e.g. the parent unpacked
with ``git archive``), it also loads that checkout's ``commpy_tpu_torch``
under another name, builds its kernels there, and times its K1, K2 and
K4, and the MCS-4 and Path A link steps, beside this tree's on the same
inputs in turns (other, this, this, other), holding the two trees'
outputs equal.

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
# that peak counts a fused multiply-add as two operations; the adds,
# multiplies, compares and selects the bounds count are one instruction
# each, at half of it.  An SM has 64 int32 lanes against 128 float32 ones.
F32_INSTR_PER_S = F32_OPS_PER_S / 2
INT32_OPS_PER_S = F32_OPS_PER_S / 4
SOURCE = "commpy_tpu_torch/kernels/csrc/viterbi_acs.cu"
QC_SOURCE = "commpy_tpu_torch/kernels/csrc/qc_bp.cu"
# float operations per edge and iteration of a min-sum check update with
# its totals and syndrome: v2c subtract, |x|, two-minimum tracking (2),
# sign and zero tracking (2), leave-one-out select, scale, offset, clamp,
# sign product, the total update and the syndrome's XOR
MSA_OPS_PER_EDGE = 15
BCJR_SOURCE = "commpy_tpu_torch/kernels/csrc/bcjr.cu"
DEMAP_SOURCE = "commpy_tpu_torch/kernels/csrc/demap.cu"
# exp and log1p on the special-function units: 16 per SM per clock, at the
# 1.98 GHz behind F32_OPS_PER_S (132 SMs x 128 lanes x 2 x 1.98 GHz)
SFU_OPS_PER_S = 16 * 132 * 1.98e9
# float operations of one lse2 besides exp and log1p: max, subtract, add
# (log-MAP); max (max-log); max, subtract, multiply, subtract, max, add
# (linear)
LSE2_FLOPS = {"exact": 3, "maxlog": 1, "linear": 5}
MS_NOTE = ("ms: CUDA events around back-to-back wrapper calls, as for every "
           "kernel; device_ms: the kernel's own device time (torch.profiler), "
           "null where five profiles held no record of the kernel")


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


def device_ms(torch, fn, reps, kernel):
    """Mean device time in ms of one launch of the kernels whose name holds
    ``kernel``, over ``reps`` calls of ``fn`` after one warm-up call
    (torch.profiler): the kernel alone, without the host's time between
    launches that CUDA events around back-to-back calls also count.  None,
    with a line that says so, when five profiles hold no record of the
    kernel: its time is then only the CUDA events' (:func:`cuda_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profile now and then comes back without the kernels' records (the
    # launches ran: their outputs are held elsewhere); after five such
    # profiles the device time is not measured, and said so
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if kernel in e.key:
                us += _device_us(e, "self_")
                n += e.count
        if n and us:
            return us / n / 1e3
    print(f"chip_smoke: the profiler saw no device time of {kernel} in five "
          "profiles; its device_ms is null", flush=True)
    return None


def ms_str(ms, digits=4):
    """A time in ms for a line of output; "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.{digits}f}"


KERNEL_NAMES = ("acs_warp_kernel", "acs_forward_kernel", "traceback_kernel",
                "qc_bp_resident_kernel", "qc_bp_streamed_kernel",
                "bcjr_kernel", "demap_joint_kernel")


def ptxas_report(paths):
    """Registers, stack and spill bytes of every compiled kernel, from the
    ``-Xptxas -v`` log beside each library: ``{kernel: [{"entry",
    "registers", "stack", "spill_stores", "spill_loads"}, ...]}``, one
    entry per template instantiation."""
    import re

    out = {}
    for path in paths.values():
        log = path.with_suffix(".log")
        if not log.exists():
            continue
        cur = None
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = next((k for k in KERNEL_NAMES if k in m.group(1)),
                            None)
                cur = {"entry": m.group(1)} if name else None
                if cur is not None:
                    out.setdefault(name, []).append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def regs_summary(entries):
    """"R-R registers, stack S, spills P" over a kernel's instantiations."""
    regs = [e.get("registers", 0) for e in entries]
    return (f"{min(regs)}-{max(regs)} registers, stack up to "
            f"{max(e.get('stack', 0) for e in entries)} bytes, spills up to "
            f"{max(e.get('spill_stores', 0) for e in entries)} bytes "
            f"({len(entries)} instantiations)")


def k1_bound(B, T, n, S):
    """Least time of the ACS pass: r read once, decisions and best states
    written once; per state-step two adds, a compare, the renormalising
    subtract and one compare of the minimum, plus the 2^n distinct branch
    metrics of each step."""
    G = -(-S // 32)
    nbytes = 4 * B * T * (n + G + 1)
    ops = B * T * (5 * S + 2 ** n * (2 * n - 1))
    return nbytes, ops


def k2_steps(T, S, tb_depth, skip=False):
    """Back-steps of a frame's full walks: each window's walk from its end
    to its position, or, with ``skip``, to log2(S) - 1 steps above it,
    where K2 stops (the MSB it emits is a bit of the state there)."""
    walk = np.minimum(min(tb_depth, T + 1) - 2, T - 1 - np.arange(T))
    msb = max(S.bit_length() - 2, 0) if skip else 0
    return int((walk - msb).clip(min=0).sum())


def k2_bound(B, T, S, steps):
    """Least time of the traceback: decisions and best states read once,
    bits written once; four integer operations per back-step, ``steps``
    back-steps in all."""
    G = -(-S // 32)
    return B * T * (4 * G + 4 + 1), 4 * steps


def bound_ms(nbytes, ops, ops_per_s=F32_INSTR_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def k2_cases():
    """(S, B, T, tb_depth, kind, staged) of the traceback cases on
    decisions of random words or all ties: every S with its decisions
    staged in shared memory and read from device memory, tb_depth past T,
    2 and 3.  ``staged`` is what the launch plan must choose."""
    cases = []
    for S in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024):
        G = -(-S // 32)
        row = 1 if G == 1 else G + 1
        T_dev = 232_448 // (4 * row) + 37  # past a block's shared memory
        cases += [(S, 5, 77, 30, "random", True),
                  (S, 2, T_dev, 30, "random", False)]
    cases += [
        (64, 3, 1205, 30, "tie", True),
        (2, 3, 77, 2, "tie", True),
        (64, 3, 300, 301, "random", True),
        (64, 3, 300, 2000, "random", True),
        (1024, 2, 40, 3, "random", True),
        (64, 2, 5000, 6000, "random", True),
        (1024, 2, 3000, 3001, "random", False),
        (1024, 2, 3000, 3001, "tie", False),
    ]
    return cases


def k2_parity(torch, tally):
    """Hold K2 to traceback_plain on the cases of :func:`k2_cases`."""
    from commpy_tpu_torch.kernels import viterbi_acs as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    for S, B, T, tb, kind, staged in k2_cases():
        if K.traceback_plan(S, T, tb, B)["staged"] != staged:
            fail(f"K2 case S={S} T={T} tb={tb}: the plan does not stage "
                 f"as the case is for (staged={staged})")
        G = -(-S // 32)
        if kind == "tie":
            dec = torch.zeros((B, T, G), dtype=torch.int32, device=dev)
            best = torch.zeros((B, T), dtype=torch.int32, device=dev)
        else:
            dec = torch.randint(-2 ** 31, 2 ** 31, (B, T, G), generator=g,
                                device=dev, dtype=torch.int64).to(
                                    torch.int32)
            best = torch.randint(0, S, (B, T), generator=g, device=dev,
                                 dtype=torch.int32)
        bits = K.traceback(dec, best, S, tb)
        torch.cuda.synchronize()
        tally.add(bits, K.traceback_plain(dec, best, S, tb))


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


def device_launches(torch, fn):
    """Kernels one call of ``fn`` runs on the device (torch.profiler), or
    "not measured" where the profile holds none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not e.key.startswith("link.") and _device_us(e, "self_") > 0)
    return n or "not measured"


def profile_link_step(torch, link, gen, noise_std, step_s, steps=2,
                      frames=2048, label="MCS-4"):
    """Device time of each kernel and of each ``link.<stage>`` span over
    ``steps`` link steps of ``frames`` frames (torch.profiler), and the
    device's busy share of the step time measured without the profiler.

    A stage has two readings: ``device_span_ms``, the extent of its span
    on the device's timeline (first kernel start to last kernel end, all
    its kernels included), and ``aten_kernels_ms``, the summed time of
    the kernels the profiler ties to PyTorch operators inside it (it does
    not tie the kernels launched through ctypes, K1, K2 and K4, to the
    span)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            link.link_step(gen, frames, noise_std)
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
    launches = sum(row["calls_per_step"] for row in rows)
    out = {"device_busy_ms_per_step": busy_ms,
           "step_ms": step_s * 1e3,
           "device_idle_share": (1 - busy_ms / (step_s * 1e3)
                                 if busy_ms else "not measured"),
           "stages_device_ms_per_step": stages,
           "device_launches_per_step": launches,
           "kernels": rows[:25],
           "kernel_names": [row["kernel"] for row in rows]}
    top = ", ".join(f"{row['kernel'][:40]} {row['ms_per_step']:.3f}"
                    for row in rows[:6])
    split = ", ".join(f"{k} {v.get('device_span_ms', float('nan')):.3f}"
                      for k, v in stages.items())
    print(f"{label} link step profile: device busy {busy_ms:.3f} ms of "
          f"{step_s * 1e3:.3f} ms in {launches:.0f} launches; stages (device "
          f"span ms): {split}; top kernels: {top}", flush=True)
    return out


class QCTally:
    """Kernel-versus-plain comparison counts of one QC-LDPC kernel.

    MSA cases count every decision and every posterior that differs
    (bit for bit); SPA cases count differing decisions and posteriors
    outside rtol = atol = 1e-4, and keep the largest relative difference
    ``|kernel - plain| / (1 + |plain|)``."""

    def __init__(self):
        self.cases = 0
        self.compared = 0
        self.mismatches = 0
        self.max_abs_err = 0.0
        self.spa_max_rel = 0.0

    def add(self, got, want, exact):
        (dg, og), (dw, ow) = got, want
        dw, ow = dw.to(dg.device), ow.to(og.device)
        for a, b in ((dg, dw), (og, ow)):
            if a.shape != b.shape or a.dtype != b.dtype:
                fail(f"shape/type {tuple(a.shape)} {a.dtype} vs "
                     f"{tuple(b.shape)} {b.dtype}")
        self.cases += 1
        self.compared += dg.numel()
        diff = (og - ow).abs()
        if diff.numel():
            self.max_abs_err = max(self.max_abs_err, float(diff.max()))
        bad = int((dg != dw).sum())
        if exact:
            bad += int((og != ow).sum())
        else:
            bad += int((diff > 1e-4 * ow.abs() + 1e-4).sum())
            if diff.numel():
                self.spa_max_rel = max(self.spa_max_rel, float(
                    (diff / (1 + ow.abs())).max()))
        self.mismatches += bad
        return bad


def bpsk_llr(cw, ebn0_db, rate, rng):
    """Channel LLRs (positive means bit 0) of BPSK codewords ``cw`` over
    AWGN at ``ebn0_db`` (a scalar or one value per frame)."""
    ebn0 = np.asarray(ebn0_db, float).reshape(-1, 1)
    sigma = np.sqrt(1 / (2 * rate * 10 ** (ebn0 / 10)))
    x = 1.0 - 2.0 * cw
    return (2 * (x + sigma * rng.randn(*cw.shape)) / sigma ** 2).astype(
        np.float32)


def qc_case_llr(cw, rate, seed, low_db=0.5):
    """Kernel input ``[B, n]`` for codewords ``cw``: lane 0 clean
    (converged at init), lane 1 the codeword in LLRs of +-0.0 (converged
    at init, decided by the zeros' signs), lane 2 noisy with 16 LLRs of
    -0.0 and 16 of +0.0, the rest noisy at Eb/N0 spread over
    ``low_db``-4 dB so that they converge at different iterations or, at
    the low end, not at all.

    SPA cases start at 2 dB: a frame that never converges amplifies a
    last-bit difference of tanh from sweep to sweep, so its posteriors
    test the two tanh implementations, not the kernel."""
    rng = np.random.RandomState(seed)
    B, n = cw.shape
    llr = bpsk_llr(cw, rng.permutation(np.linspace(low_db, 4.0, B)), rate,
                   rng)
    llr[0] = (1.0 - 2.0 * cw[0]) * 20
    if B > 1:
        llr[1] = np.where(cw[1] == 1, np.float32(-0.0), np.float32(0.0))
    if B > 2:
        pos = rng.permutation(n)[:32]
        llr[2, pos[:16]] = np.float32(-0.0)
        llr[2, pos[16:]] = np.float32(0.0)
    return np.clip(llr, -500, 500)


def ldpc_codes():
    """(name, qc params, codeword maker ``(B, rng) -> [B, n]`` int8 or
    None) of every code the QC kernels are held on."""
    from commpy_tpu_torch.ops import dvbs2 as D
    from commpy_tpu_torch.ops import ldpc as L
    from commpy_tpu_torch.ops import nrldpc as N
    from commpy_tpu_torch.ops import qcldpc as Q

    def qc_maker(p):
        enc = Q.qc_encoder(p, "cpu")
        return lambda B, rng: enc(rng.randint(0, 2, (B, p["k_bits"])).astype(
            np.int8)).numpy()

    codes = {}
    for (n, r) in sorted(Q.IEEE80211N_BASE):
        p = Q.ieee80211n_params(n, r)
        codes[f"80211n-{n}-{r}"] = (p, qc_maker(p))
    wimax = L.get_ldpc_code_params(
        os.path.join(L.DESIGNS, "wimax", "1440.720.txt"))
    codes["wimax-1440"] = (L._maybe_qc_params(wimax),
                           lambda B, rng: np.zeros((B, 1440), np.int8))
    pd = D.dvbs2_qc_params(D.synthetic_address_table(16200, "1/2", seed=0),
                           16200, "1/2")
    q, k = pd["dvbs2"]["q"], pd["k_bits"]

    def dvbs2_qc_codewords(B, rng):
        cw = D.dvbs2_encode_device(rng.randint(0, 2, (B, k)).astype(np.int8),
                                   pd, device="cpu")
        # the kernels see parity bits in the QC order (block a, position b)
        return np.concatenate(
            [cw[:, :k].numpy(),
             D._parity_to_qc(cw[:, k:], q, pd["Z"]).numpy()], axis=1)

    codes["dvbs2-16200-1/2"] = (pd, dvbs2_qc_codewords)
    pn = N.nr_code_params(1, 208)
    codes["nr-bg1-z208"] = (pn, lambda B, rng: N.nr_encode_device(
        rng.randint(0, 2, (B, pn["k_bits"])).astype(np.int8), pn,
        device="cpu").numpy())
    return codes


def qc_compare(torch, tally, kernel, plain, llr, exact, on_cpu, **kw):
    """Run ``kernel`` on the card and ``plain`` on the card (and on the
    host when ``on_cpu``) on the same LLRs; returns the kernel's output.

    The host leg is for MSA only: the CPU's float32 tanh differs from the
    card's in the last bit, and near tanh's saturation that moves an SPA
    message between ~17 and the +-500 clip.  SPA is held on the card,
    where the kernel's tanhf and log1pf are PyTorch's own."""
    got = kernel(llr, **kw)
    want = plain(llr, **kw)
    torch.cuda.synchronize()
    bad = tally.add(got, want, exact)
    if on_cpu:
        bad += tally.add((got[0].cpu(), got[1].cpu()), plain(llr.cpu(), **kw),
                         exact)
    if bad:
        case = {k: v for k, v in kw.items() if k not in ("meta", "pos_masks")}
        fail(f"{kernel.__name__} disagrees with its plain version: {bad} "
             f"values at B={llr.shape[0]}, n={llr.shape[1]}, {case}")
    return got


def k4_synthetic():
    """Codes no standard has, for K4's loops: Mb*Z = 1536 checks past a
    block's 1024 threads (flooding loops), and rows of 17 blocks (the
    512-thread row bound of 32) at Z = 640 (both schedules loop).  Random
    shifts from a fixed seed; every column has a block."""
    rng = np.random.RandomState(77)

    def code(Z, Nb, rows):
        return (Z, Nb, tuple(tuple((j, int(rng.randint(Z))) for j in r)
                             for r in rows))
    return {
        "loop-z256": code(256, 12, [[0, 1, 2, 6], [2, 3, 4, 7], [4, 5, 0, 8],
                                    [6, 7, 9, 1], [8, 9, 10, 3],
                                    [10, 11, 5, 9]]),
        "wide-z640": code(640, 18, [list(range(17)),
                                    [17] + list(range(16))]),
    }


def k4_parity(torch, tally, codes):
    """The resident kernel against its plain version on every 802.11n
    code and WiMAX 1440 (B = 1, 3, 37, 397 and 512), and the synthetic
    codes of :func:`k4_synthetic`."""
    from commpy_tpu_torch.kernels import qc_bp as Q
    from commpy_tpu_torch.ops.qcldpc import qc_rows

    dev = torch.device("cuda")
    variants = [("MSA", "flooding", 1.0), ("MSA", "layered", 1.0),
                ("SPA", "flooding", 1.0), ("SPA", "layered", 1.0),
                ("MSA", "flooding", 0.75), ("MSA", "layered", 0.75)]
    big = {"80211n-1944-1/2": variants, "80211n-648-5/6": variants[:1],
           "80211n-1296-2/3": variants[1:2], "wimax-1440": variants[:1]}
    cases = []
    for name, (p, make) in codes.items():
        if name.startswith(("dvbs2", "nr")):
            continue
        meta = (p["Z"], p["Nb"], qc_rows(p))
        rate = p["k_bits"] / p["n_vnodes"]
        for B in (1, 3, 37, 397, 512):
            vs = (variants if B in (3, 37) else variants[:2] if B in (1, 397)
                  else big.get(name, []))
            cases += [(meta, rate, make, B, v) for v in vs]
    for meta in k4_synthetic().values():
        n = meta[0] * meta[1]
        make = (lambda B, rng, n=n: np.zeros((B, n), np.int8))
        cases += [(meta, 0.5, make, 3, v) for v in variants[:4]]
        cases += [(meta, 0.5, make, 37, v) for v in variants[:2]]
    seed = 1000
    for meta, rate, make, B, (alg, sched, sc) in cases:
        seed += 1
        rng = np.random.RandomState(seed)
        llr = torch.as_tensor(qc_case_llr(
            make(B, rng), rate, seed, 0.5 if alg == "MSA" else 2.0),
            device=dev)
        qc_compare(torch, tally, Q.qc_bp_resident, Q.qc_bp_resident_plain,
                   llr, alg == "MSA", B <= 64 and alg == "MSA",
                   algorithm=alg, n_iters=8, meta=meta, schedule=sched,
                   msa_scale=sc)


K5_VARIANTS = [("MSA", "f32", 1.0), ("MSA", "bf16", 1.0),
               ("SPA", "f32", 1.0), ("SPA", "bf16", 1.0),
               ("MSA", "f32", 0.75), ("MSA", "bf16", 0.75)]
# codes no standard has, for two paths of K5: a column repeated within a
# check block row (barriers before the repeated block) and a single check
# block row (its ring is refilled from its own messages)
K5_SYNTHETIC = {
    "repeat-col-z64": (64, 12, (
        ((0, 0), (1, 3), (0, 17), (2, 5)), ((2, 1), (3, 0), (4, 9), (3, 33)),
        ((4, 2), (5, 7), (6, 0)), ((6, 11), (7, 4), (8, 0), (6, 40), (7, 1)),
        ((8, 5), (9, 0), (10, 3)), ((10, 8), (11, 0), (9, 21), (11, 13)))),
    "one-row-z32": (32, 3, (((0, 0), (1, 5), (2, 9)),)),
}


def k5_cases(codes):
    """(name, meta, pos_masks, rate, codeword maker, B, variants) of every
    K5 parity case: the DVB-S2-class 16200 code (pos_masks), NR BG1 Z=208
    (rows of up to 24 blocks) and 802.11n 648 at B = 3, 37 and 512; then a
    batch of one, a batch that is no multiple of the frames in flight
    (397), and the two synthetic codes."""
    from commpy_tpu_torch.ops.qcldpc import _pos_masks, qc_rows

    v = K5_VARIANTS
    real = {}
    for name in ("dvbs2-16200-1/2", "nr-bg1-z208", "80211n-648-1/2"):
        p, make = codes[name]
        real[name] = ((p["Z"], p["Nb"], qc_rows(p)), _pos_masks(p),
                      p["k_bits"] / p["n_vnodes"], make)
    for name, meta in K5_SYNTHETIC.items():
        n = meta[0] * meta[1]
        real[name] = (meta, (), 0.5,
                      lambda B, rng, n=n: np.zeros((B, n), np.int8))
    big = {"dvbs2-16200-1/2": v[:3], "nr-bg1-z208": v[:1],
           "80211n-648-1/2": v[1:2]}
    cases = []
    for name in ("dvbs2-16200-1/2", "nr-bg1-z208", "80211n-648-1/2"):
        for B in (3, 37, 512):
            cases.append((name, B, v if B < 512 else big[name]))
    cases += [("dvbs2-16200-1/2", 1, v[:4]), ("dvbs2-16200-1/2", 397, v[:4]),
              ("nr-bg1-z208", 397, v[:4])]
    cases += [(name, B, v) for name in K5_SYNTHETIC for B in (3, 37)]
    return [(name, *real[name], B, variants) for name, B, variants in cases]


def k5_parity(torch, tally, codes):
    """The streamed kernel against its plain version in every case of
    :func:`k5_cases`."""
    from commpy_tpu_torch.kernels import qc_bp as Q

    dev = torch.device("cuda")
    seed = 2000
    for name, meta, pm, rate, make, B, variants in k5_cases(codes):
        for alg, io, sc in variants:
            seed += 1
            rng = np.random.RandomState(seed)
            llr = torch.as_tensor(qc_case_llr(
                make(B, rng), rate, seed, 0.5 if alg == "MSA" else 2.0),
                device=dev)
            qc_compare(torch, tally, Q.qc_bp_streamed,
                       Q.qc_bp_streamed_plain, llr, alg == "MSA",
                       B <= 3 and alg == "MSA", algorithm=alg,
                       n_iters=6, meta=meta, msa_scale=sc, pos_masks=pm,
                       msg_io=io)


def qc_bound(B, n, edges, iters, store_bytes=0):
    """Least time of a QC BP decode: LLRs read once, posteriors (float32)
    and decisions (int8) written once, against MSA_OPS_PER_EDGE per edge
    and iteration for ``iters`` (a [B] array: the sweeps each frame
    needs).  ``store_bytes``, the streamed kernel's message store read and
    written once per sweep, is reported beside it (``store_bound``)."""
    nbytes = B * n * (4 + 4 + 1)
    ops = MSA_OPS_PER_EDGE * edges * int(np.sum(iters))
    return nbytes, ops, 2 * store_bytes * edges * int(np.sum(iters))


def sweeps_needed(torch, params, dec, n_iters):
    """Sweeps each frame ran, as far as the outputs tell: ``n_iters`` for
    a frame whose decisions fail the syndrome, 1 for one that passes (it
    may have stopped sooner, so the bound stays a lower bound)."""
    from commpy_tpu_torch.kernels.qc_bp import _graph, _syndrome_bad
    from commpy_tpu_torch.ops.qcldpc import _pos_masks, qc_rows

    g = _graph((params["Z"], params["Nb"], qc_rows(params)),
               _pos_masks(params))
    bad = _syndrome_bad(dec, g, dec.device).cpu().numpy()
    return np.where(bad, n_iters, 1)


def sweeps_run(torch, params, llr_qc, n_iters, msg_io):
    """Sweeps K5 runs on each frame of its input ``llr_qc``: the least k
    whose decode with ``n_iters=k`` passes the syndrome (a frame stops
    there), else ``n_iters``."""
    from commpy_tpu_torch.kernels import qc_bp as QK
    from commpy_tpu_torch.ops.qcldpc import _pos_masks, qc_rows

    meta = (params["Z"], params["Nb"], qc_rows(params))
    pm = _pos_masks(params)
    g = QK._graph(meta, pm)
    sweeps = np.full(llr_qc.shape[0], n_iters)
    for k in range(n_iters - 1, -1, -1):
        dec, _ = QK.qc_bp_streamed(llr_qc, "MSA", k, meta, pos_masks=pm,
                                   msg_io=msg_io)
        sweeps[~QK._syndrome_bad(dec, g, dec.device).cpu().numpy()] = k
    return sweeps


def k5_at_grid(torch, x, meta, pm, io, grid):
    """K5 (MSA, 8 sweeps) on ``x`` with ``grid`` blocks in place of its
    launch plan's, held to the plan's bits: its device time, the grid and
    the store of the frames in flight."""
    from commpy_tpu_torch.kernels import qc_bp as QK

    g = QK._graph(meta, pm)
    want = QK.qc_bp_streamed(x, "MSA", 8, meta, pos_masks=pm, msg_io=io)
    plan = QK.streamed_plan(g["Z"], g["Nb"], g["kmax"], g["E"], x.shape[0],
                            io, QK.sm_count(x.device.index))
    plan = dict(plan, grid=grid, store_elems=grid * g["E"] * plan["Zp"])

    def run():
        return QK._streamed_launch(x, g, "MSA", 8, 1.0, 0.0, io, plan)
    got = run()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"K5 with {grid} blocks disagrees with its own plan")
    return {"device_ms": device_ms(torch, run, 5, "qc_bp_streamed_kernel"),
            "grid": grid, "store_mb": plan["store_elems"]
            * (2 if io == "bf16" else 4) / 1e6}


def rsc_trellises():
    """The RSC component codes K3 is held on: S = 2, 4 (the turbo link's),
    8 (LTE's constraint length) and 16 states, and the 8-state code with
    its states 1-7 relabelled, a bijective trellis that is not
    shift-structured."""
    import copy

    from commpy_tpu_torch.ops.trellis import Trellis

    codes = [(2, Trellis(np.array([1]), np.array([[1, 3]]), 3, "rsc")),
             (4, Trellis(np.array([2]), np.array([[1, 7]]), 5, "rsc")),
             (8, Trellis(np.array([3]), np.array([[1, 15]]), 13, "rsc")),
             (16, Trellis(np.array([4]), np.array([[1, 0o37]]), 0o21, "rsc"))]
    t = copy.copy(codes[2][1])
    perm = np.r_[0, 1 + np.random.RandomState(0).permutation(7)]
    nst = np.empty_like(t.next_state_table)
    out = np.empty_like(t.output_table)
    nst[perm] = perm[t.next_state_table]
    out[perm] = t.output_table
    t.next_state_table, t.output_table = nst, out
    t._build_inverse_tables()
    return codes + [(8, t)]


class K3Tally:
    """Kernel-versus-plain comparison counts of K3.

    Every output value (e, and the carries of the boundary variant) is
    compared bit for bit.  Max-log and linear values that differ are
    mismatches.  A log-MAP value that differs is a last-bit difference
    (``bit_diffs``), and a mismatch only past the fallback limit: another
    decision (sign) or ``|kernel - plain| > 1e-5 (1 + |plain|)``."""

    def __init__(self):
        self.cases = 0
        self.compared = 0
        self.mismatches = 0
        self.bit_diffs = 0
        self.max_abs_err = 0.0
        self.max_rel_err = 0.0

    def add(self, got, want, exact):
        bad = 0
        for g, w in zip(got, want):
            w = w.to(g.device)
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"shape/type {tuple(g.shape)} {g.dtype} vs "
                     f"{tuple(w.shape)} {w.dtype}")
            diff = (g - w).abs()
            neq = g != w
            self.compared += g.numel()
            self.bit_diffs += int(neq.sum())
            if exact:
                neq = ((g > 0) != (w > 0)) | (diff > 1e-5 * (1 + w.abs()))
            bad += int(neq.sum())
            if diff.numel():
                self.max_abs_err = max(self.max_abs_err, float(diff.max()))
                self.max_rel_err = max(self.max_rel_err,
                                       float((diff / (1 + w.abs())).max()))
        self.cases += 1
        self.mismatches += bad
        return bad


def k3_inputs(torch, S, T, R, variant, seed, dev, halo=4):
    """Inputs of one K3 case on ``dev``: w-stream-sized streams (randn * 4,
    as (sy +- pa)/nv at nv = 0.5) and priors (randn * 8); the masked
    variant gets ``halo`` invalid rows at each end and a random ``first``,
    the boundary variant random start metrics."""
    rng = np.random.RandomState(seed)
    syn, pan = (torch.as_tensor(rng.randn(T, R).astype(np.float32) * 4,
                                device=dev) for _ in range(2))
    li = torch.as_tensor(rng.randn(T, R).astype(np.float32) * 8, device=dev)
    kw = {}
    if variant == "masked":
        valid = np.ones((T, R), bool)
        valid[:min(halo, T // 3)] = False
        valid[T - min(halo, T // 3):] = False
        kw = {"valid": torch.as_tensor(valid, device=dev),
              "first": torch.as_tensor(rng.rand(R) < 0.5, device=dev)}
    elif variant == "boundary":
        kw = {"boundary": tuple(torch.as_tensor(
            rng.randn(S, R).astype(np.float32) * 3, device=dev)
            for _ in range(2))}
    return syn, pan, li, kw


def k3_call(torch, syn, pan, li, trellis, hist=None, **kw):
    """K3 on CUDA inputs by its own launch plan, or with the history
    placed as ``hist`` says ("shared" or "global")."""
    from commpy_tpu_torch.kernels import bcjr as BK

    if hist is None:
        return BK.bcjr_appdiff(syn, pan, li, trellis, **kw)
    args = dict(max_log=False, valid=None, first=None, io_dtype="f32",
                boundary=None, lse=None, combined=False, renorm_every=0)
    args.update({k: v for k, v in kw.items() if k in args})
    mode, _, *streams = BK._prepare(syn, pan, li, trellis, *args.values())
    T, R = syn.shape
    plan = BK.bcjr_plan(T, trellis.number_states, R, hist=hist)
    return BK._bcjr_launch(trellis, mode, *streams, li, args["boundary"],
                           kw.get("posterior", False), plan,
                           args["renorm_every"])


def k3_compare(torch, tally, trellis, S, T, R, mode, variant, io, combined,
               posterior, seed, on_cpu, hists=(None,), renorm_every=0):
    """K3 (by its own plan, or with each history placement of ``hists``)
    and its plain version on the card (and, for max-log and linear when
    ``on_cpu``, the plain version on the host) on the same inputs."""
    from commpy_tpu_torch.kernels import bcjr as BK

    dev = torch.device("cuda")
    syn, pan, li, vkw = k3_inputs(torch, S, T, R, variant, seed, dev)
    kw = dict(vkw, max_log=mode == "maxlog",
              lse="linear" if mode == "linear" else None, io_dtype=io,
              combined=combined, posterior=posterior,
              renorm_every=renorm_every)
    want = BK.bcjr_appdiff_plain(syn, pan, li, trellis, **kw)
    want = want if isinstance(want, tuple) else (want,)
    bad = 0
    for hist in hists:
        got = k3_call(torch, syn, pan, li, trellis, hist, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        bad += tally.add(got, want, mode == "exact")
    if on_cpu and mode != "exact":
        cpu = k3_inputs(torch, S, T, R, variant, seed, torch.device("cpu"))
        want_c = BK.bcjr_appdiff_plain(*cpu[:3], trellis,
                                       **dict(kw, **cpu[3]))
        want_c = want_c if isinstance(want_c, tuple) else (want_c,)
        bad += tally.add(tuple(g.cpu() for g in got), want_c, False)
    if bad:
        fail(f"bcjr_appdiff disagrees with its plain version: {bad} values "
             f"at S={S}, T={T}, R={R}, {mode}, {variant}, io={io}, "
             f"combined={combined}, posterior={posterior}, hist={hists}, "
             f"renorm_every={renorm_every}")


K3_BENCH = {  # (T, R, variant) of the three JAX bench decoders' K3 calls
    "whole_frame": (256, 4096, "plain"),  # L=256, B=4096
    "warmup_window": (320, 6144, "masked"),  # L=6144, B=256, (256, 32)
    "nii": (128, 12288, "boundary"),  # L=6144, B=256, (128, 0): Path C
}


def k3_parity(torch, tally, trellises):
    """K3 against its plain version: every trellis of ``rsc_trellises``
    under the three lse2 modes and the three variants, f32 and bf16 io,
    combined and posterior on and off, at small shapes (T = 1, odd T, R
    not a multiple of 32); T = 1, 2 and 3 in every mode and variant;
    both history placements at a small shape for every S and at the
    three bench shapes where shared memory holds them; and S = 16 at
    T = 320, which the plan sends to device memory."""
    from commpy_tpu_torch.kernels import bcjr as BK

    shapes = [(1, 37), (7, 100), (33, 130), (64, 32)]
    ios = [("f32", False, False), ("bf16", True, False), ("f32", True, True),
           ("bf16", False, True)]
    modes = ("exact", "maxlog", "linear")
    variants = ("plain", "masked", "boundary")
    seed = 3000
    for S, tr in trellises:
        for mode in modes:
            for variant in variants:
                seed += 1
                T, R = shapes[seed % 4]
                io, comb, post = ios[(seed // 4) % 4]
                k3_compare(torch, tally, tr, S, T, R, mode, variant, io, comb,
                           post, seed, True)
    tr4 = trellises[1][1]
    for i, (T, R, variant) in enumerate(K3_BENCH.values()):
        for io in ("f32", "bf16"):
            hists = [None, "global"]
            try:
                BK.bcjr_plan(T, 4, R, hist="shared")
                hists.append("shared")
            except ValueError:
                pass
            k3_compare(torch, tally, tr4, 4, T, R, "exact", variant, io, True,
                       True, 4000 + 2 * i + (io == "bf16"), False, hists)
    # T = 1, 2, 3: the halves are empty or of one step
    seed = 4100
    for S, tr in trellises[:4]:
        for T in (1, 2, 3):
            for j, mode in enumerate(modes):
                for variant in (variants if S == 4 else
                                [variants[(T + j) % 3]]):
                    seed += 1
                    io, comb, post = ios[seed % 4]
                    k3_compare(torch, tally, tr, S, T, 45, mode, variant, io,
                               comb, post, seed, True, ("shared", "global"))
    # both placements for every S, odd T and R
    for S, tr in trellises:
        for variant in variants:
            seed += 1
            k3_compare(torch, tally, tr, S, 33, 130, "exact", variant, "f32",
                       False, False, seed, False, (None, "shared", "global"))
    # S = 16 at T = 320: 640 KB of history a block, so device memory
    if BK.bcjr_plan(320, 16, 96)["hist"] != "global":
        fail("K3's plan keeps S=16, T=320 in shared memory")
    for mode in modes:
        seed += 1
        k3_compare(torch, tally, trellises[3][1], 16, 320, 96, mode,
                   "masked", "f32", True, True, seed, False)


def k3_renorm_parity(torch, tally, trellises):
    """K3 with ``renorm_every`` 1, 2 and 4 against its plain version at
    the same period: S = 2, 4, 8 and 16, the masked and boundary variants,
    T = 1, 3 (below the period 4) and 33 (odd, the halves 16 and 17 steps),
    R = 45 (a block's tail lanes dead), the three lse2 modes in turn,
    both history placements.  Every value must match bit for bit, log-MAP
    too (``tally.bit_diffs``)."""
    modes = ("exact", "maxlog", "linear")
    ios = [("f32", False, False), ("bf16", True, False), ("f32", True, True)]
    seed = 4500
    for S, tr in trellises[:4]:
        for N in (1, 2, 4):
            for variant in ("masked", "boundary"):
                for T in (1, 3, 33):
                    seed += 1
                    io, comb, post = ios[seed % 3]
                    k3_compare(torch, tally, tr, S, T, 45, modes[seed % 3],
                               variant, io, comb, post, seed, False,
                               ("shared", "global"), renorm_every=N)


def k3_bound(T, R, S, mode, variant, io_bytes=4, renorm_every=0):
    """Least time of one K3 pass: the streams (w1, w2, li) read once and e
    written once (the masks, and the boundary metrics in and out, too);
    per lane and step 6S + 9 adds and subtracts (branch metrics with the
    prior, candidates, APP terms, e) and 4S - 2 lse2 of LSE2_FLOPS float
    operations each, plus an exp and a log1p each in log-MAP on the
    special-function units.  With ``renorm_every`` N, each recursion also
    takes a lane's maximum (S - 1 max) and subtracts it (S) every N steps.
    Returns (bytes, float operations, special operations, history bytes):
    this design's alpha history, written and read once, is reported beside
    it as ``store_bound_ms``."""
    steps = T * R
    nbytes = 4 * steps * io_bytes
    if variant == "masked":
        nbytes += steps + R
    if variant == "boundary":
        nbytes += 4 * S * R * 4
    n_lse = 4 * S - 2
    flops = steps * (6 * S + 9 + n_lse * LSE2_FLOPS[mode])
    if renorm_every:
        flops += 2 * (T // renorm_every) * R * (2 * S - 1)
    sfu = 2 * steps * n_lse if mode == "exact" else 0
    return nbytes, flops, sfu, 2 * steps * S * 4


def k3_bound_ms(nbytes, flops, sfu):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_INSTR_PER_S, sfu / SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k6_bound(n, m, maxlog=False):
    """Least work of one K6 call on ``n`` symbols of an ``m``-point
    constellation: the symbols (8 bytes) read and ``log2(m)`` float32 LLRs
    written once; per point the distance's 5 float operations and the
    division; per bit and half (m/2 points) m/2 - 1 maxima and, for the
    exact LLR, the maximum's test, m/2 subtractions, m/2 - 1 adds and the
    add after the log; a subtraction a bit; and for the exact LLR m exps
    and 2 logs a bit on the special-function units.  Returns (bytes, float
    operations, special operations) for :func:`k3_bound_ms`."""
    bps = int(np.log2(m))
    h = m // 2
    half = h - 1 + (0 if maxlog else 1 + h + h - 1 + 1)
    flops = n * (6 * m + bps * (2 * half + 1))
    sfu = 0 if maxlog else n * bps * (m + 2)
    return n * (8 + 4 * bps), flops, sfu


def k6_symbols(torch, const, shape, snr_db, seed, dev, per_symbol=False):
    """Noisy symbols of ``const`` at Es/N0 ``snr_db`` and their noise
    variance: a float32 scalar, or with ``per_symbol`` a variance a symbol
    drawn from 0.5x to 2x it (faded links' effective variances)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pts = torch.as_tensor(const, device=dev)
    es = float(np.mean(np.abs(const) ** 2))
    sd = float(np.sqrt(es / 2 / 10 ** (snr_db / 10)))
    idx = torch.randint(0, len(const), shape, generator=gen, device=dev)
    z = torch.randn((2,) + tuple(shape), generator=gen, device=dev)
    y = pts[idx] + torch.complex(z[0], z[1]) * sd
    nv = np.float32(2 * sd * sd)
    if per_symbol:
        nv = float(nv) * 2 ** (torch.rand(shape, generator=gen, device=dev)
                               * 2 - 1)
    return y, nv


def k6_phase(torch, report):
    """K6 against its plain version on the card, bit for bit: 16-QAM at the
    benchmark cells' shapes (F=2048 x 2688 symbols at 9 and 13 dB, F=4096
    x 486 at 11 and 12.5 dB; 15M symbols, exact and max-log), every order
    K6 takes (2-64 PSK and 4-64 QAM) with scalar and per-symbol noise
    variances, and far-out symbols; then its time at both cell shapes by
    CUDA events and torch.profiler beside its bound, the plain version's
    time and the per-axis (separable) path's on the same 16-QAM input."""
    from commpy_tpu_torch.kernels import demap as DK
    from commpy_tpu_torch.ops import modem as M

    dev = torch.device("cuda")
    qam16 = M.qam_constellation(16).astype(np.complex64)
    cases = [(qam16, (2048, 2688), snr, False) for snr in (9.0, 13.0)]
    cases += [(qam16, (4096, 486), snr, False) for snr in (11.0, 12.5)]
    for m in DK.ORDERS:
        cases.append((M.psk_constellation(m).astype(np.complex64),
                      (256, 1000), 8.0, True))
        if m in (4, 16, 64):
            cases.append((M.qam_constellation(m).astype(np.complex64),
                          (256, 1000), 14.0, True))
    out = {"symbols": 0, "llrs": 0, "mismatches": 0, "max_ulp": 0}
    for i, (const, shape, snr, per_symbol) in enumerate(cases):
        y, nv = k6_symbols(torch, const, shape, snr, 600 + i, dev,
                           per_symbol)
        variants = [(y, nv)]
        if per_symbol:  # far out: one symbol in 8 scaled by 1e3 to 1e9
            far = 10.0 ** torch.randint(3, 10, shape, device=dev)
            keep = torch.rand(shape, device=dev) < 0.875
            variants.append((torch.where(keep, y, y * far),
                             np.float32(1e-4)))
        bps = int(np.log2(len(const)))
        for yy, v in variants:
            for maxlog in (False, True):
                got = DK.demap_joint(yy, const, v, maxlog)
                want = M._demodulate_joint(yy, const, bps, v,
                                           M._max if maxlog else M._lse)
                bad = got.view(torch.int32) != want.view(torch.int32)
                out["symbols"] += yy.numel()
                out["llrs"] += got.numel()
                out["mismatches"] += int(bad.sum())
                if bad.any():
                    gap = (got.view(torch.int32).long()
                           - want.view(torch.int32).long()).abs()
                    out["max_ulp"] = max(out["max_ulp"], int(gap.max()))
                del got, want, bad
    torch.cuda.synchronize()
    print(f"K6 parity: {out['mismatches']} mismatching LLRs (bits) in "
          f"{out['llrs']} over {out['symbols']} symbols, largest gap "
          f"{out['max_ulp']} ulp", flush=True)
    if out["mismatches"]:
        fail("K6 disagrees with its plain version")
    timing = {}
    for name, shape, snr in (("bcc_step", (2048, 2688), 11.0),
                             ("ldpc_step", (4096, 486), 12.0)):
        y, nv = k6_symbols(torch, qam16, shape, snr, 700, dev)
        n = y.numel()
        t = {"symbols": n,
             "ms": cuda_ms(torch, lambda: DK.demap_joint(y, qam16, nv), 20),
             "device_ms": device_ms(torch, lambda: DK.demap_joint(
                 y, qam16, nv), 20, "demap_joint_kernel"),
             "maxlog_ms": cuda_ms(torch, lambda: DK.demap_joint(
                 y, qam16, nv, True), 20),
             "plain_ms": cuda_ms(torch, lambda: M._demodulate_joint(
                 y, qam16, 4, nv, M._lse), 3),
             "separable_ms": cuda_ms(torch, lambda: M.demodulate_soft(
                 y, qam16, 4, nv, method="separable"), 5),
             "bound": k6_bound(n, 16), "maxlog_bound": k6_bound(n, 16, True)}
        bound, by = k3_bound_ms(*t["bound"])
        t.update(bound_ms=bound, bound_by=by,
                 roofline_pct=100 * bound / (t["device_ms"] or t["ms"]))
        timing[name] = t
        print(f"K6 {name} ({n} 16-QAM symbols): {t['ms']:.4f} ms a call, "
              f"{ms_str(t['device_ms'])} ms of device time, bound "
              f"{bound:.4f} ms by {by} ({t['roofline_pct']:.1f}%); max-log "
              f"{t['maxlog_ms']:.4f} ms; plain {t['plain_ms']:.3f} ms, "
              f"separable {t['separable_ms']:.3f} ms", flush=True)
    out["timing"] = timing
    report["k6"] = out
    return out


class K6Watch:
    """K6's launches on each path of the script, and the plain joint
    demapper's calls on the card: ``count(label, fn)`` runs ``fn()`` with
    ``demap_joint.launches`` set to 0 and ``ops.modem._demodulate_joint``
    wrapped, and keeps both counts under ``label``.  A plain call on a
    complex64 or float32 CUDA tensor of an order K6 takes is a call that
    K6 should have taken: any fails the script; complex128 symbols and the
    larger orders are the plain version's and are only counted."""

    def __init__(self, torch):
        from commpy_tpu_torch.kernels import demap as DK
        from commpy_tpu_torch.ops import modem as M

        self.torch, self.DK, self.M = torch, DK, M
        self.launches, self.plain_cuda, self.missed = {}, {}, {}

    def count(self, label, fn, must=True):
        """``fn()``; fails if it reached the plain version where K6 should
        have run, or (``must``: a path that soft-demaps on the card)
        launched K6 not once."""
        torch, DK, M = self.torch, self.DK, self.M
        plain, seen = M._demodulate_joint, [0, 0]

        def watched(symbols, constellation, bits_per_symbol, *rest):
            if symbols.is_cuda:
                seen[0] += 1
                seen[1] += (symbols.dtype in (torch.complex64, torch.float32)
                            and DK.takes(len(M._const_numpy(constellation)),
                                         bits_per_symbol))
            return plain(symbols, constellation, bits_per_symbol, *rest)
        DK.demap_joint.launches = 0
        M._demodulate_joint = watched
        try:
            out = fn()
        finally:
            M._demodulate_joint = plain
        n = DK.demap_joint.launches
        self.launches[label], self.plain_cuda[label] = n, seen[0]
        self.missed[label] = seen[1]
        print(f"{label}: demap_joint launches {n}; plain joint demapper on "
              f"the card {seen[0]} calls, {seen[1]} of them K6's to take",
              flush=True)
        if seen[1]:
            fail(f"{label}: {seen[1]} joint-path calls on the card reached "
                 f"the plain demapper")
        if must and not n:
            fail(f"{label} never launched demap_joint")
        return out


def load_other_port(root):
    """``commpy_tpu_torch`` of the checkout at ``root``, imported as the
    package ``other_port`` (its kernels build under ``root/build``): its
    ACS and QC BP kernel modules and its link models."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "commpy_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "other_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("other_port.kernels.viterbi_acs"),
            importlib.import_module("other_port.kernels.qc_bp"),
            importlib.import_module("other_port.models"))


def host_ms(torch, fn, reps):
    """Mean wall time of ``fn`` in ms on the host clock, over ``reps``
    calls after one, ending in ``torch.cuda.synchronize()``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def ab_compare(torch, runs):
    """Each of ``runs`` ({name: (kernel name or None, this tree's call, the
    other tree's call)}) timed in turns, other, this, this, other, the two
    trees' outputs held equal: a kernel by device time (torch.profiler)
    and CUDA events a call, a link step (kernel name None) by the host
    clock."""
    out = {}
    for name, (kname, mine, other) in runs.items():
        a, b = mine(), other()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"A/B {name}: the two trees' outputs differ")
        rec = {}
        for who, fn in (("other", other), ("this", mine), ("this", mine),
                        ("other", other)):
            if kname is None:
                rec.setdefault(f"{who}_host_ms", []).append(
                    host_ms(torch, fn, 5))
                continue
            rec.setdefault(f"{who}_device_ms", []).append(
                device_ms(torch, fn, 10, kname))
            rec.setdefault(f"{who}_ms", []).append(cuda_ms(torch, fn, 10))
        out[name] = rec
        print(f"A/B {name}: " + "; ".join(f"{k} {v}" for k, v in rec.items()),
              flush=True)
    return out


def link_draws(torch, link, frames, seed):
    """Bits, unit complex noise and channel of a MIMO or OFDM link, drawn
    as its ``link_step`` draws them."""
    from commpy_tpu_torch.ops.channel import crandn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bits = torch.randint(0, 2, (frames, link.frame_bits), generator=g,
                         device=dev, dtype=torch.int8)
    noise = crandn(g, (frames,) + link.extras["noise_shape"], dev)
    h = crandn(g, (frames,) + link.extras["channel_shape"], dev) * \
        link.extras["channel_scale"]
    return bits, noise, h


def step_errors(torch, link, frames, snr_db, seed):
    """Bit errors of one ``link_step`` of ``frames`` frames at ``snr_db``."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return int(link.link_step(g, frames, float(link.noise_std_fn(snr_db))))


def time_link(torch, link, frames, snr_db, seed, label, reps=3):
    """Step time (s), info bits/s and the profile of one link."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    ns = float(link.noise_std_fn(snr_db))
    link.link_step(g, frames, ns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        link.link_step(g, frames, ns)
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / reps
    prof = profile_link_step(torch, link, g, ns, step, steps=2,
                             frames=frames, label=label)
    names = prof["kernel_names"]
    ours = [n for n in names if any(k in n for k in KERNEL_NAMES)]
    print(f"{label}: step {step * 1e3:.3f} ms, "
          f"{frames * link.frame_bits / step:.4g} info bits/s at "
          f"{snr_db:.2f} dB; {len(names)} device kernels, of them the "
          f"port's: {ours}", flush=True)
    return {"step_s": step, "info_bits_per_s": frames * link.frame_bits
            / step, "snr_db": snr_db, "frames": frames, "profile": prof}


def require_kernels(timing, label, wanted):
    for w in wanted:
        if not any(w in name for name in timing["profile"]["kernel_names"]):
            fail(f"{label}: the profiled step launched no {w}")


def mc(link, snrs, seed, frames, rounds):
    from commpy_tpu_torch.parallel import montecarlo_ber

    return montecarlo_ber(link.link_step, snrs, link.noise_std_fn,
                          link.frame_bits, seed=seed,
                          frames_per_round=frames, max_rounds=rounds,
                          err_min=10 ** 9, device="cuda")


def k4_on(torch, qc_params, llr, tally):
    """K4 against its plain version on a link's own LLRs (clipped as the
    decoder clips them), MSA-15 flooding: decisions and posteriors bit
    for bit."""
    from commpy_tpu_torch.kernels import qc_bp as QK
    from commpy_tpu_torch.ops.qcldpc import _llr_max, qc_rows

    meta = (qc_params["Z"], qc_params["Nb"], qc_rows(qc_params))
    x = torch.clamp(llr.reshape(llr.shape[0], -1), -_llr_max,
                    _llr_max).contiguous()
    qc_compare(torch, tally, QK.qc_bp_resident, QK.qc_bp_resident_plain, x,
               True, False, algorithm="MSA", n_iters=15, meta=meta)


def mimo_ofdm_paths(torch, report, k7):
    """Paths D-G: the K-best MIMO link, the best-first WiMAX LDPC MIMO
    link, the OFDM-MIMO conv link and the OFDM-LDPC link, each through
    ``montecarlo_ber`` with the kernel counts set to 0 just before and
    read just after; the kernels of each path against their plain
    versions on the path's own inputs; the links' rates and profiles.
    Returns {kernel: {path: launches}} and the parity tallies."""
    from commpy_tpu_torch.kernels import qc_bp as QK
    from commpy_tpu_torch.kernels import viterbi_acs as K
    from commpy_tpu_torch.models import (make_bestfirst_ldpc_mimo_link,
                                         make_kbest_mimo_link,
                                         make_ofdm_mimo_conv_link,
                                         make_ofdm_qcldpc_link)
    from commpy_tpu_torch.ops import ldpc as L
    from commpy_tpu_torch.ops import modem as M
    from commpy_tpu_torch.ops import qcldpc as Q
    from commpy_tpu_torch.ops.mimo import kbest_device, mimo_ml_device
    from commpy_tpu_torch.ops.viterbi import (received_words,
                                              viterbi_decode_device)
    from commpy_tpu_torch.utils import small_matmul

    launches = {"acs_forward": {}, "traceback": {}, "qc_bp_resident": {}}
    k4_tally = QCTally()
    k12_tallies = {"acs_forward": Tally(), "traceback": Tally()}
    out = {}

    # ---- Path D: uncoded 4x4 16-QAM K-best(16), 65,536 vectors a step
    kb = make_kbest_mimo_link(nb_tx=4, nb_rx=4, modulation_m=16, K=16,
                              vectors_per_frame=32)
    snr_d = 10.0 + 10 * np.log10(4)
    res = mc(kb, [snr_d], 30, 2048, 2)
    e60 = step_errors(torch, kb, 2048, 60.0, 31)
    ber_d = float(res.bers[0])
    # K-best on the card against the plain search on the host, same draws
    bits, noise, h = link_draws(torch, kb, 2048, 32)
    const = M.qam_constellation(16).astype(np.complex64)
    x = M.modulate(bits, const, 4).reshape(2048, 32, 4)
    ns = float(np.float32(kb.noise_std_fn(snr_d)))
    y = small_matmul(h, x[..., None])[..., 0] + noise * float(
        np.float32(ns) * np.float32(0.5))
    yv, hv = y.reshape(-1, 4), h.reshape(-1, 4, 4)
    xh = kbest_device(yv, hv, const, 16)
    xh_cpu = kbest_device(yv.cpu(), hv.cpu(), const, 16, device="cpu")
    differ = float((xh.cpu() != xh_cpu).any(-1).float().mean())
    # exhaustive ML at a size whose candidate grid fits (2x2 16-QAM,
    # [65536, 2, 256] complex64): the card against the host
    y2, h2 = yv[:, :2].contiguous(), hv[:, :2, :2].contiguous()
    ml = mimo_ml_device(y2, h2, const)
    ml_differ = float((ml.cpu() != mimo_ml_device(
        y2.cpu(), h2.cpu(), const, device="cpu")).any(-1).float().mean())
    out["path_d"] = {"ber": ber_d, "snr_db": snr_d,
                     "bits_sent": float(res.bits_sent[0]),
                     "errs_60db": e60,
                     "kbest_card_vs_cpu_vectors_differ": differ,
                     "ml_2x2_card_vs_cpu_vectors_differ": ml_differ,
                     "vectors": int(yv.shape[0])}
    print(f"Path D K-best 4x4 16-QAM K=16 F=2048 (65,536 vectors): BER "
          f"{ber_d:.4e} at {snr_d:.2f} dB (reference 3e-2, rtol 1.25); "
          f"{e60} errors at 60 dB; K-best card vs host plain: {differ:.3e} "
          f"of vectors differ; 2x2 ML card vs host: {ml_differ:.3e}",
          flush=True)
    if not abs(ber_d - 3e-2) <= 1.25 * 3e-2 or e60 != 0:
        fail(f"Path D: BER {ber_d} at {snr_d:.2f} dB, {e60} errors at 60 dB")
    if differ > 1e-4 or ml_differ > 1e-4:
        fail(f"Path D: {differ} of vectors' K-best symbols and {ml_differ} "
             f"of their ML symbols differ between the card and the host")
    out["path_d"]["timing"] = time_link(torch, kb, 2048, snr_d, 33,
                                        "Path D K-best MIMO")

    # ---- Path E: best-first + WiMAX LDPC(1440,720) MSA-15 on K4
    wimax = L.get_ldpc_code_params(os.path.join(L.DESIGNS, "wimax",
                                                "1440.720.txt"), True)
    bf = make_bestfirst_ldpc_mimo_link(ldpc_params=wimax, beam=32)
    QK.qc_bp_resident.launches = 0
    res = mc(bf, [17.0, 18.0, 19.0], 34, 512, 2)
    launches["qc_bp_resident"]["E"] = QK.qc_bp_resident.launches
    bers_e = [float(b) for b in res.bers]
    desired = np.array([1.7e-1, 1e-1, 2.5e-3])
    kbe = make_bestfirst_ldpc_mimo_link(ldpc_params=wimax, beam=16,
                                        detector="kbest")
    res_k = mc(kbe, [21.0], 35, 512, 1)
    ber_k = float(res_k.bers[0])
    out["path_e"] = {"bers": bers_e, "snrs_db": [17.0, 18.0, 19.0],
                     "reference": desired.tolist(),
                     "bits_sent": float(res.bits_sent[0]),
                     "kbest16_21db_ber": ber_k,
                     "launches": launches["qc_bp_resident"]["E"]}
    print(f"Path E best-first(32) + WiMAX LDPC MSA-15, F=512 (46,080 "
          f"vectors): BER {bers_e} at 17/18/19 dB (reference "
          f"{desired.tolist()}, rtol 2, at most 1.5x); K-best(16) at 21 dB "
          f"{ber_k:.3e}; qc_bp_resident launches "
          f"{launches['qc_bp_resident']['E']}", flush=True)
    if not (np.all(np.abs(np.array(bers_e) - desired) <= 2 * desired)
            and np.all(np.array(bers_e) <= 1.5 * desired)):
        fail(f"Path E BER {bers_e} is off the reference curve")
    if not ber_k < 2e-2:
        fail(f"Path E K-best(16) BER at 21 dB is {ber_k}")
    if launches["qc_bp_resident"]["E"] == 0:
        fail("Path E never launched qc_bp_resident")
    qc_w = wimax["_qc_lift"]
    for link, snr, seed in ((bf, 18.0, 36), (kbe, 21.0, 37)):
        bits, noise, h = link_draws(torch, link, 512, seed)
        llr = link.receive(bits, noise, float(link.noise_std_fn(snr)), h)
        k4_on(torch, qc_w, llr, k4_tally)
    out["path_e"]["timing"] = time_link(torch, bf, 512, 18.0, 38,
                                        "Path E best-first LDPC MIMO")
    require_kernels(out["path_e"]["timing"], "Path E",
                    ["qc_bp_resident_kernel"])

    # ---- Path F: OFDM + 2x2 16-QAM K-best(8) + K=7 soft Viterbi (config 5)
    of = make_ofdm_mimo_conv_link(trellis=k7, modulation_m=16, nb_tx=2,
                                  nb_rx=2, K=8, nfft=64, nsc=48, cp_length=16,
                                  n_ofdm_symbols=4)
    K.acs_forward.launches = 0
    K.traceback.launches = 0
    res = mc(of, [35.0, 5.0], 39, 2048, 1)
    launches["acs_forward"]["F"] = K.acs_forward.launches
    launches["traceback"]["F"] = K.traceback.launches
    bers_f = [float(b) for b in res.bers]
    out["path_f"] = {"bers": bers_f, "snrs_db": [35.0, 5.0],
                     "bits_sent": float(res.bits_sent[0]),
                     "launches": {k: v["F"] for k, v in launches.items()
                                  if "F" in v}}
    print(f"Path F OFDM 2x2 16-QAM K-best(8) + K=7 soft Viterbi, F=2048: "
          f"BER {bers_f} at 35/5 dB; launches {out['path_f']['launches']}",
          flush=True)
    if not (bers_f[0] < 0.01 and bers_f[1] > bers_f[0]):
        fail(f"Path F BER {bers_f} at 35/5 dB")
    if not (launches["acs_forward"]["F"] and launches["traceback"]["F"]):
        fail("Path F never launched the ACS or traceback kernel")
    bits, noise, h = link_draws(torch, of, 2048, 40)
    rx = of.receive(bits, noise, float(of.noise_std_fn(14.0)), h)
    if not bool(torch.isinf(rx).any()):
        fail("Path F: the detector gave no +-inf LLR to clip")
    f_tallies = {"acs_forward": Tally(), "traceback": Tally()}
    compare_case(torch, f_tallies, k7, "soft", 2048, of.frame_bits, 30, 0,
                 r=received_words(rx, k7, "soft", of.frame_bits))
    kern = viterbi_decode_device(rx, k7, 30, "soft", L=of.frame_bits)
    plain = viterbi_decode_device(rx, k7, 30, "soft", L=of.frame_bits,
                                  backend="torch")
    f_tallies["traceback"].add(kern, plain)
    for name, t in f_tallies.items():
        if t.mismatches:
            fail(f"Path F: {name} disagrees with its plain version on the "
                 f"path's LLRs ({t.mismatches} of {t.compared})")
    out["path_f"]["parity"] = {k: (t.mismatches, t.compared)
                               for k, t in f_tallies.items()}
    out["path_f"]["timing"] = time_link(torch, of, 2048, 14.0, 41,
                                        "Path F OFDM-MIMO conv")
    require_kernels(out["path_f"]["timing"], "Path F",
                    ["acs_warp_kernel", "traceback_kernel"])

    # ---- Path G: OFDM + 802.11n LDPC (1944, 1/2) 16-QAM, 4-tap Rayleigh
    q1944 = Q.ieee80211n_params(1944, "1/2")

    def ofdm(**kw):
        return make_ofdm_qcldpc_link(qc_params=q1944, modulation_m=16, **kw)

    g_links = {csi: ofdm(csi=csi) for csi in ("perfect", "ls", "smooth")}
    QK.qc_bp_resident.launches = 0
    res = mc(g_links["perfect"], [35.0, 13.0], 42, 512, 1)
    launches["qc_bp_resident"]["G"] = QK.qc_bp_resident.launches
    clean = {csi: step_errors(torch, lk, 512, 35.0, 43)
             for csi, lk in g_links.items()}
    # LS against its delay-subspace smoothing on the same draws
    wf = {csi: step_errors(torch, g_links[csi], 512, 13.0, 44)
          for csi in ("ls", "smooth")}
    # blind CP sync: the JAX package's own configuration (648, QPSK,
    # smoothed CSI, CFO 0.31) and this path's (1944, 16-QAM, LS CSI, 0.2)
    q648 = Q.ieee80211n_params(648, "1/2")
    cfo_648 = {c: step_errors(torch, make_ofdm_qcldpc_link(
        qc_params=q648, modulation_m=4, csi="smooth", cfo=0.31,
        cfo_correction=c), 512, 30.0, 45) for c in (True, False)}
    cfo_1944 = {c: step_errors(torch, ofdm(csi="ls", cfo=0.2,
                                           cfo_correction=c), 512, 35.0, 46)
                for c in (True, False)}
    cfo_1944_zero = step_errors(torch, ofdm(csi="ls", cfo_correction=True),
                                512, 35.0, 46)
    nb = 512 * 972
    out["path_g"] = {"bers_perfect": [float(b) for b in res.bers],
                     "snrs_db": [35.0, 13.0], "errs_35db": clean,
                     "waterfall_13db_errs": wf, "bits_a_step": nb,
                     "cfo031_648_qpsk_smooth_30db_errs": cfo_648,
                     "cfo02_1944_16qam_ls_35db_errs": cfo_1944,
                     "cfo0_corrected_1944_16qam_ls_35db_errs": cfo_1944_zero,
                     "launches": launches["qc_bp_resident"]["G"]}
    print(f"Path G OFDM 802.11n LDPC 1944 16-QAM 4-tap, F=512: perfect-CSI "
          f"BER {out['path_g']['bers_perfect']} at 35/13 dB; errors at 35 dB "
          f"{clean}; at 13 dB LS {wf['ls']}, smoothed {wf['smooth']} of "
          f"{nb}; CFO 0.31 (648 QPSK smooth, 30 dB) corrected/not "
          f"{cfo_648[True]}/{cfo_648[False]} of {512 * 324}; CFO 0.2 (1944 "
          f"16-QAM LS, 35 dB) corrected/not {cfo_1944[True]}/"
          f"{cfo_1944[False]}, no CFO but corrected {cfo_1944_zero}; "
          f"qc_bp_resident launches {launches['qc_bp_resident']['G']}",
          flush=True)
    if any(clean.values()):
        fail(f"Path G: errors at 35 dB {clean}")
    if not wf["smooth"] <= wf["ls"] or wf["ls"] == 0:
        fail(f"Path G: smoothed CSI {wf['smooth']} vs LS {wf['ls']} errors")
    # the CP estimator reads the channel's inter-symbol interference in
    # the first n_taps - 1 samples of each CP as offset, so even a zero
    # CFO leaves a residual whose phase drift grows over the frame: the
    # JAX package's link shows the same floor (its own 1944 16-QAM link
    # errs at 35 dB); the check is that correction removes almost all of
    # the offset's damage
    if not cfo_648[True] * 100 < cfo_648[False]:
        fail(f"Path G: CFO sync at 648 QPSK {cfo_648}")
    if not cfo_1944[True] * 10 < cfo_1944[False]:
        fail(f"Path G: CFO sync at 1944 16-QAM {cfo_1944}")
    if launches["qc_bp_resident"]["G"] == 0:
        fail("Path G never launched qc_bp_resident")
    for csi, seed in (("perfect", 47), ("ls", 48)):
        lk = g_links[csi]
        bits, noise, h = link_draws(torch, lk, 512, seed)
        k4_on(torch, q1944, lk.receive(bits, noise,
                                       float(lk.noise_std_fn(13.0)), h),
              k4_tally)
    out["path_g"]["timing"] = time_link(torch, g_links["ls"], 512, 13.0, 49,
                                        "Path G OFDM-LDPC (LS CSI)")
    require_kernels(out["path_g"]["timing"], "Path G",
                    ["qc_bp_resident_kernel"])
    print(f"K4 on Paths E and G's own LLRs: {k4_tally.mismatches} "
          f"mismatches in {k4_tally.cases} cases, {k4_tally.compared} "
          f"decisions", flush=True)
    out["k4_path_parity"] = {"mismatches": k4_tally.mismatches,
                             "cases": k4_tally.cases,
                             "compared": k4_tally.compared}
    report.update(out)
    return launches


def auto_past_the_limits(torch, report):
    """'auto' decodes a K=12 (2048-state) convolutional code and a
    32-state turbo code on the card, by the general and torch routes, as
    the plain routes do; 'cuda' raises with the kernel's limit."""
    from commpy_tpu_torch.ops.trellis import Trellis
    from commpy_tpu_torch.ops.turbo import (turbo_decode_device,
                                            turbo_encode_device)
    from commpy_tpu_torch.ops.viterbi import viterbi_decode_device

    dev = torch.device("cuda")
    rng = np.random.RandomState(50)
    k12 = Trellis(np.array([11]), np.array([[0o4335, 0o5723]]))
    x = torch.as_tensor((rng.randn(64, 2 * 200) * 2).astype(np.float32),
                        device=dev)
    a = viterbi_decode_device(x, k12, 60, "soft", L=200)
    b = viterbi_decode_device(x, k12, 60, "soft", L=200, backend="torch")
    rsc32 = Trellis(np.array([5]), np.array([[1, 0o67]]), 0o45, "rsc")
    p = rng.permutation(512)
    msg = torch.as_tensor(rng.randint(0, 2, (64, 512)).astype(np.int8),
                          device=dev)
    y = [2.0 * s.to(torch.float32) - 1.0 + torch.as_tensor(
        rng.randn(64, 512).astype(np.float32), device=dev) * 0.8
         for s in turbo_encode_device(msg, rsc32, rsc32, p)]
    ta = turbo_decode_device(*y, rsc32, 0.64, 4, p)
    tb = turbo_decode_device(*y, rsc32, 0.64, 4, p, backend="torch")
    raised = []
    for call in (lambda: viterbi_decode_device(x, k12, 60, "soft", L=200,
                                               backend="cuda"),
                 lambda: turbo_decode_device(*y, rsc32, 0.64, 4, p,
                                             backend="cuda")):
        try:
            call()
        except NotImplementedError as e:
            raised.append(str(e)[:80])
    out = {"k12_auto_vs_plain_bits_differ": int((a != b).sum()),
           "rsc32_auto_vs_torch_bits_differ": int((ta != tb).sum()),
           "rsc32_ber": float((ta != msg).float().mean()),
           "cuda_raised": raised}
    print(f"'auto' past the kernels' limits: {out}", flush=True)
    if out["k12_auto_vs_plain_bits_differ"] or \
            out["rsc32_auto_vs_torch_bits_differ"] or len(raised) != 2:
        fail(f"'auto' routing past the kernels' limits: {out}")
    report["auto_past_limits"] = out


def link_receive(torch, link, frames, snr_db, seed):
    """Bits and the decoder input of a link without a channel draw (Paths
    H-L), drawn as its ``link_step`` draws them."""
    from commpy_tpu_torch.ops.channel import crandn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bits = torch.randint(0, 2, (frames, link.frame_bits), generator=g,
                         device=dev, dtype=torch.int8)
    noise = crandn(g, (frames,) + link.extras["noise_shape"], dev)
    return bits, link.receive(bits, noise, float(link.noise_std_fn(snr_db)))


def viterbi_on_link(torch, link, snr_db, seed, label, k7):
    """K1 and K2 against their plain versions on a link's own LLRs (its
    receive chain at ``snr_db``, F=2048), and the whole decode by the
    kernel route against the plain route."""
    _, rx = link_receive(torch, link, 2048, snr_db, seed)
    return viterbi_parity(torch, rx, k7, link.frame_bits, 30, label)


def viterbi_parity(torch, rx, trellis, L, tb_depth, label, decoded=None):
    """K1 and K2 against their plain versions on soft decoder input ``rx``
    [B, n L / k] (made into kernel input by the decoder's own
    ``received_words``), and the whole decode against the plain route:
    ``decoded`` (the bits a path decoded), or else the kernel route's.
    Fails on any mismatch."""
    from commpy_tpu_torch.ops.viterbi import (received_words,
                                              viterbi_decode_device)

    tallies = {"acs_forward": Tally(), "traceback": Tally()}
    compare_case(torch, tallies, trellis, "soft", rx.shape[0], L, tb_depth,
                 0, r=received_words(rx, trellis, "soft", L))
    plain = viterbi_decode_device(rx, trellis, tb_depth, "soft", L=L,
                                  backend="torch")
    if decoded is None:
        decoded = viterbi_decode_device(rx, trellis, tb_depth, "soft", L=L)
    tallies["traceback"].add(
        torch.as_tensor(decoded, dtype=plain.dtype, device=plain.device),
        plain)
    for name, t in tallies.items():
        if t.mismatches:
            fail(f"{label}: {name} disagrees with its plain version on the "
                 f"path's LLRs ({t.mismatches} of {t.compared})")
    return {k: (t.mismatches, t.compared) for k, t in tallies.items()}


def with_errors(rng, cw, n_err, symbols=None):
    """``cw`` (a host array) with ``n_err`` errors a word at distinct
    positions: bits flipped, or symbols XORed with a non-zero value below
    ``symbols``."""
    rx = cw.copy()
    for b in range(cw.shape[0]):
        pos = rng.choice(cw.shape[1], n_err, replace=False)
        rx[b, pos] ^= 1 if symbols is None else rng.randint(1, symbols,
                                                            n_err)
    return rx


def dsp_code_paths(torch, report, k7):
    """Paths H-L: the RRC and ISI conv links (K1, K2), the BCH decoders and
    link and the turbo product code, the RS decoder and link, and the
    DVB-S2 BCH + LDPC concatenation (K5), each link through
    ``montecarlo_ber`` with the kernel counts set to 0 just before and
    read just after; the kernels against their plain versions on the
    paths' own inputs; the decoders' and links' rates and profiles, and
    the equalizer at the JAX bench's shape.  Returns {kernel: {path:
    launches}}."""
    from commpy_tpu_torch.kernels import qc_bp as QK
    from commpy_tpu_torch.kernels import viterbi_acs as K
    from commpy_tpu_torch.models import (make_bch_awgn_link,
                                         make_conv_awgn_link,
                                         make_dvbs2_concat_link,
                                         make_isi_conv_link,
                                         make_rrc_conv_awgn_link,
                                         make_rs_awgn_link)
    from commpy_tpu_torch.ops import bch as BC
    from commpy_tpu_torch.ops import dvbs2 as D
    from commpy_tpu_torch.ops import equalize as E
    from commpy_tpu_torch.ops import rs as RS
    from commpy_tpu_torch.ops import tpc as TPC
    from commpy_tpu_torch.ops.qcldpc import _llr_max, _pos_masks, qc_rows

    dev = torch.device("cuda")
    launches = {"acs_forward": {}, "traceback": {}, "qc_bp_streamed": {}}
    out = {}

    def counted(kernels, path, run):
        for kern in kernels:
            kern.launches = 0
        res = run()
        for kern in kernels:
            launches[kern.__name__][path] = kern.launches
            if not kern.launches:
                fail(f"Path {path} never launched {kern.__name__}")
        return res

    # ---- Path H: RRC pulse-shaped 16-QAM K=7 soft, F=2048, 12 dB
    rrc = make_rrc_conv_awgn_link(trellis=k7, modulation_m=16,
                                  frame_bits=1200, sps=4, rrc_span_symbols=8,
                                  rrc_alpha=0.35)
    res = counted((K.acs_forward, K.traceback), "H",
                  lambda: mc(rrc, [12.0, 35.0, 5.0], 60, 2048, 1))
    errs_h = [int(e) for e in res.bit_errors]
    # the unity-gain Nyquist cascade: with exact LLRs the waveform link
    # errs as the symbol-rate link of the same code and constellation
    rrc_exact = make_rrc_conv_awgn_link(trellis=k7, modulation_m=16,
                                        frame_bits=1200, use_maxlog=False)
    sym = make_conv_awgn_link(trellis=k7, modulation_m=16, frame_bits=1200,
                              decoding_type="soft", use_psk=False)
    snrs = [8.0, 9.0, 10.0, 11.0, 12.0]
    e_wave = mc(rrc_exact, snrs, 63, 2048, 2).bit_errors
    e_sym = mc(sym, snrs, 64, 2048, 2).bit_errors
    both = [i for i in range(len(snrs)) if min(e_wave[i], e_sym[i]) >= 1000]
    if not both:
        fail(f"Path H: no SNR of {snrs} where both links count 1000 errors "
             f"(waveform {e_wave}, symbol rate {e_sym})")
    i = both[-1]
    ratio = float(e_wave[i] / e_sym[i])
    out["path_h"] = {"errs_12_35_5db": errs_h,
                     "bits_a_step": 2048 * 1200,
                     "exact_llr_errs": {"snrs_db": snrs,
                                        "waveform": e_wave.tolist(),
                                        "symbol_rate": e_sym.tolist(),
                                        "compared_at_db": snrs[i],
                                        "ratio": ratio},
                     "launches": {k: v["H"] for k, v in launches.items()
                                  if "H" in v}}
    print(f"Path H RRC 16-QAM K=7 max-log, F=2048: errors at 12/35/5 dB "
          f"{errs_h}; exact LLRs, waveform vs symbol-rate link errors "
          f"{e_wave.tolist()} vs {e_sym.tolist()} at {snrs} dB, ratio "
          f"{ratio:.3f} at {snrs[i]} dB; launches {out['path_h']['launches']}",
          flush=True)
    if not errs_h[1] == 0 < errs_h[2]:
        fail(f"Path H: errors at 35/5 dB {errs_h[1:]}")
    if not 1 / 1.5 <= ratio <= 1.5:
        fail(f"Path H: waveform/symbol-rate error ratio {ratio} at "
             f"{snrs[i]} dB")
    out["path_h"]["parity"] = viterbi_on_link(torch, rrc, 12.0, 65,
                                              "Path H", k7)
    out["path_h"]["timing"] = time_link(torch, rrc, 2048, 12.0, 66,
                                        "Path H RRC conv")
    require_kernels(out["path_h"]["timing"], "Path H",
                    ["acs_warp_kernel", "traceback_kernel"])

    # ---- Path I: ISI channel H3 + 21-tap MMSE, QPSK K=7 soft, F=2048, 8 dB
    h3 = (np.array([1.0, 0.45, -0.2]) + 1j * np.array([0.1, -0.3, 0.05])
          ).astype(np.complex64)
    isi = make_isi_conv_link(trellis=k7, channel_taps=h3, n_eq_taps=21,
                             modulation_m=4, frame_bits=1200)
    res = counted((K.acs_forward, K.traceback), "I",
                  lambda: mc(isi, [8.0, 35.0, 2.0], 67, 2048, 1))
    errs_i = [int(e) for e in res.bit_errors]
    one_tap = make_isi_conv_link(trellis=k7, channel_taps=h3, n_eq_taps=1,
                                 modulation_m=4, frame_bits=1200)
    e_eq = step_errors(torch, isi, 2048, 8.0, 68)
    e_one = step_errors(torch, one_tap, 2048, 8.0, 68)
    out["path_i"] = {"errs_8_35_2db": errs_i, "bits_a_step": 2048 * 1200,
                     "errs_8db_21tap_vs_1tap": [e_eq, e_one],
                     "launches": {k: v["I"] for k, v in launches.items()
                                  if "I" in v}}
    print(f"Path I ISI H3 + MMSE-21 QPSK K=7, F=2048: errors at 8/35/2 dB "
          f"{errs_i}; at 8 dB 21 taps {e_eq} vs 1 tap {e_one}; launches "
          f"{out['path_i']['launches']}", flush=True)
    if not errs_i[1] == 0 < errs_i[2]:
        fail(f"Path I: errors at 35/2 dB {errs_i[1:]}")
    if not e_eq * 10 < e_one:
        fail(f"Path I: the 21-tap equalizer ({e_eq} errors) does not beat "
             f"one tap ({e_one}) tenfold at 8 dB")
    out["path_i"]["parity"] = viterbi_on_link(torch, isi, 8.0, 69, "Path I",
                                              k7)
    out["path_i"]["timing"] = time_link(torch, isi, 2048, 8.0, 70,
                                        "Path I ISI MMSE conv")
    require_kernels(out["path_i"]["timing"], "Path I",
                    ["acs_warp_kernel", "traceback_kernel"])

    # equalizer at the JAX bench's shape (bench_all.py equalize_mmse_t31_l5):
    # per-batch MMSE taps, B=256, n=4096, Lh=5, T=31
    rng = np.random.RandomState(71)
    he = torch.as_tensor(((rng.randn(256, 5) + 1j * rng.randn(256, 5))
                          * np.sqrt(0.5 / 5)).astype(np.complex64),
                         device=dev)
    ye = torch.as_tensor((rng.randn(256, 4096) + 1j * rng.randn(256, 4096)
                          ).astype(np.complex64), device=dev)
    d31 = E.equalizer_delay(31, 5)

    def eq_bench():
        w = E.mmse_fir_taps(he, 0.05, 31)
        return torch.vmap(lambda yy, ww: E.equalize(yy, ww, d31))(ye, w)

    z = eq_bench()
    w = E.mmse_fir_taps(he, 0.05, 31)
    for b in (0, 255):
        if not torch.equal(z[b], E.equalize(ye[b], w[b], d31)):
            fail(f"equalizer bench: the mapped row {b} differs from its "
                 "own equalize")
    eq_ms = cuda_ms(torch, eq_bench, 10)
    out["equalize_mmse_t31_l5"] = {"ms": eq_ms,
                                   "msamples_per_s": 256 * 4096 / eq_ms / 1e3}
    print(f"equalize_mmse_t31_l5 (B=256, n=4096, Lh=5, T=31, per-batch "
          f"taps): {eq_ms:.4f} ms, {256 * 4096 / eq_ms / 1e3:.1f} "
          f"Msamples/s", flush=True)

    # ---- Path J: BCH decoders, the (31,21) link, the product code
    outer16 = BC.bch_construct(16, 12, shorten=(1 << 16) - 1 - 16200)
    rng = np.random.RandomState(72)
    cw = BC.bch_encode(outer16, rng.randint(0, 2, (256, outer16.k)))
    rx = torch.as_tensor(with_errors(rng, cw.cpu().numpy(), 12), device=dev)
    dec16 = BC.make_bch_decoder(outer16)
    corr, n_err, ok = dec16(rx)
    if not (bool(ok.all()) and bool((n_err == 12).all())
            and torch.equal(corr, cw)):
        fail(f"Path J: BCH(16200, t=12) decoded {int(ok.sum())} of 256 "
             f"words, n_err {n_err.unique().tolist()}")
    bch_ms = cuda_ms(torch, lambda: dec16(rx), 5)
    c31 = BC.bch_construct(5, 2)
    hard31 = make_bch_awgn_link(code=c31, decoder="hard")
    chase31 = make_bch_awgn_link(code=c31, decoder="chase", chase_p=4)
    eh = step_errors(torch, hard31, 4096, 4.0, 73)
    ec = step_errors(torch, chase31, 4096, 4.0, 73)
    if not eh > 3 * ec > 0:
        fail(f"Path J: (31,21) hard {eh} vs Chase {ec} errors at 4 dB")
    rng = np.random.RandomState(74)
    data = rng.randint(0, 2, (64, 21, 21))
    cwt = TPC.tpc_encode(c31, c31, data).cpu().numpy()
    llr_t = torch.as_tensor(((1.0 - 2.0 * cwt) * 4.0 + rng.normal(
        0, 1.4, cwt.shape)).astype(np.float32), device=dev)
    tpc = TPC.make_tpc_decoder(c31, c31, iterations=4, p=4)
    d_card, _ = tpc(llr_t)
    d_cpu, _ = TPC.make_tpc_decoder(c31, c31, iterations=4, p=4,
                                    device="cpu")(llr_t[:4].cpu())
    tpc_differ = int((d_card[:4].cpu() != d_cpu).sum())
    if tpc_differ:
        fail(f"Path J: the product decoder on the card differs from the "
             f"host in {tpc_differ} bits of the first 4 frames")
    tpc_ms = cuda_ms(torch, lambda: tpc(llr_t), 3)
    out["path_j"] = {
        "bch_dvbs2_16200_t12": {"ms": bch_ms, "info_bits_per_s":
                                256 * outer16.k / (bch_ms * 1e-3),
                                "words": 256, "errors_a_word": 12},
        "bch31_4db_errs_hard_chase": [eh, ec], "bits_a_step": 4096 * 21,
        "tpc_31_21_sq_chase4": {"ms": tpc_ms, "info_bits_per_s":
                                64 * 441 / (tpc_ms * 1e-3),
                                "data_errs": int((d_card.cpu().numpy()
                                                  != data).sum()),
                                "card_vs_host_bits_differ": tpc_differ}}
    print(f"Path J: bch_dvbs2_16200_t12 B=256 (12 errors a word, all "
          f"corrected) {bch_ms:.3f} ms, "
          f"{out['path_j']['bch_dvbs2_16200_t12']['info_bits_per_s']:.4g} "
          f"info bits/s; (31,21) link at 4 dB hard {eh} vs Chase-4 {ec} "
          f"errors of {4096 * 21}; tpc_31_21_sq_chase4 B=64 {tpc_ms:.3f} "
          f"ms, {out['path_j']['tpc_31_21_sq_chase4']['info_bits_per_s']:.4g}"
          f" info bits/s, card = host on 4 frames", flush=True)
    out["path_j"]["timing"] = time_link(torch, chase31, 4096, 4.0, 75,
                                        "Path J BCH (31,21) Chase-4")

    # ---- Path K: RS(255,223) decoder, RS(204,188) link hard and GMD
    c255 = RS.rs_construct(8, 16)
    rng = np.random.RandomState(76)
    cw = RS.rs_encode(c255, rng.randint(0, 256, (2048, c255.k)))
    rx = torch.as_tensor(with_errors(rng, cw.cpu().numpy(), 16, 256),
                         device=dev)
    dec255 = RS.make_rs_decoder(c255)
    corr, n_err, ok = dec255(rx)
    if not (bool(ok.all()) and bool((n_err == 16).all())
            and torch.equal(corr, cw)):
        fail(f"Path K: RS(255,223) decoded {int(ok.sum())} of 2048 words")
    rs_ms = cuda_ms(torch, lambda: dec255(rx), 3)
    c204 = RS.rs_construct(8, 8, shorten=51, fcr=0)
    rs_links = {d: make_rs_awgn_link(code=c204, decoder=d)
                for d in ("hard", "gmd")}
    rs_errs = {d: [step_errors(torch, lk, 2048, snr, 77)
                   for snr in (40.0, 15.0)] for d, lk in rs_links.items()}
    out["path_k"] = {
        "rs_255_223_t16": {"ms": rs_ms, "info_bits_per_s":
                           2048 * c255.k * 8 / (rs_ms * 1e-3),
                           "words": 2048, "errors_a_word": 16},
        "rs204_errs_40_15db": rs_errs, "bits_a_step": 2048 * 188 * 8}
    print(f"Path K: rs_255_223_t16 B=2048 (16 symbol errors a word, all "
          f"corrected) {rs_ms:.3f} ms, "
          f"{out['path_k']['rs_255_223_t16']['info_bits_per_s']:.4g} info "
          f"bits/s; RS(204,188) 256-QAM link errors at 40/15 dB {rs_errs}",
          flush=True)
    for d, (hi, lo) in rs_errs.items():
        if not hi == 0 < lo:
            fail(f"Path K: RS(204,188) {d} errors at 40/15 dB {hi}/{lo}")
    out["path_k"]["timing"] = {
        d: time_link(torch, lk, 2048, 15.0, 78, f"Path K RS(204,188) {d}")
        for d, lk in rs_links.items()}

    # ---- Path L: DVB-S2 BCH(t=12) + LDPC (16200, 1/2) QPSK, MSA-30, F=512
    pd = D.dvbs2_qc_params(D.synthetic_address_table(16200, "1/2", seed=0),
                           16200, "1/2")
    cc = make_dvbs2_concat_link(qc_params=pd)
    res = counted((QK.qc_bp_streamed,), "L",
                  lambda: mc(cc, [5.0, 1.0], 79, 512, 1))
    errs_l = [int(e) for e in res.bit_errors]
    print(f"Path L DVB-S2 BCH(t=12, k={cc.frame_bits}) + LDPC (16200, 1/2) "
          f"QPSK MSA-30, F=512: errors at 5/1 dB {errs_l}; qc_bp_streamed "
          f"launches {launches['qc_bp_streamed']['L']}", flush=True)
    if not errs_l[0] == 0 < errs_l[1]:
        fail(f"Path L: errors at 5/1 dB {errs_l}")
    # K5 on a step's own LLRs, as the decoder hands them to it
    q, Z, k = pd["dvbs2"]["q"], pd["Z"], pd["k_bits"]
    k5_tally = QCTally()
    stages = {}
    for snr, seed in ((5.0, 80), (1.0, 81)):
        _, llr = link_receive(torch, cc, 512, snr, seed)
        x = torch.cat([llr[:, :k], D._parity_to_qc(llr[:, k:], q, Z)], -1)
        x = torch.clamp(x, -_llr_max, _llr_max).contiguous()
        qc_compare(torch, k5_tally, QK.qc_bp_streamed,
                   QK.qc_bp_streamed_plain, x, True, False, algorithm="MSA",
                   n_iters=30, meta=(Z, pd["Nb"], qc_rows(pd)),
                   msa_scale=0.75, pos_masks=_pos_masks(pd), msg_io="f32")
        # the stages apart: the LDPC decode and the BCH decode
        dec, _ = D.dvbs2_decode_device(llr, pd, "MSA", 30, msa_scale=0.75)
        words = dec[:, :k].to(torch.int8)
        dec_bch = BC.make_bch_decoder(cc.extras["outer"])
        _, n_fix, ok = dec_bch(words)
        stages[str(snr)] = {
            "ldpc_ms": cuda_ms(torch, lambda: D.dvbs2_decode_device(
                llr, pd, "MSA", 30, msa_scale=0.75), 3),
            "bch_ms": cuda_ms(torch, lambda: dec_bch(words), 3),
            "bch_words_corrected": int((ok & (n_fix > 0)).sum()),
            "bch_words_refused": int((~ok).sum())}
    # the Chien search's products: n_blocks x [F, (t+1)m] @ [(t+1)m, D*m]
    chien_flop = 2 * 512 * 13 * 16 * 512 * 16 * 128
    out["path_l"] = {"errs_5_1db": errs_l, "bits_a_step": 512 * cc.frame_bits,
                     "launches": launches["qc_bp_streamed"]["L"],
                     "k5_parity": {"mismatches": k5_tally.mismatches,
                                   "cases": k5_tally.cases,
                                   "compared": k5_tally.compared},
                     "stages_ms": stages, "chien_flop_a_step": chien_flop}
    print(f"Path L stages (CUDA events, F=512): {stages}; Chien search "
          f"{chien_flop:.3g} flop a step; K5 on the path's LLRs: "
          f"{k5_tally.mismatches} mismatches in {k5_tally.cases} cases, "
          f"{k5_tally.compared} values", flush=True)
    out["path_l"]["timing"] = time_link(torch, cc, 512, 5.0, 82,
                                        "Path L DVB-S2 BCH + LDPC")
    require_kernels(out["path_l"]["timing"], "Path L",
                    ["qc_bp_streamed_kernel"])
    report.update(out)
    return launches


def polar_path(torch, report):
    """Path M: polar codes at the JAX bench's configuration
    (``benchmarks/bench_all.py:297-341``), N=1024, K=512, design Es/N0
    2 dB, with and without CRC-11.  The QPSK SCL-8 + CRC-11 link at F=512
    through ``montecarlo_ber`` at Eb/N0 2 dB; its physics (clean at Eb/N0
    6 dB, errors at -1 dB, fewer frame errors than SC on the same draws at 2 dB,
    SCL with one path decoding as SC); the SC, scan SCL and unrolled SCL
    decoders at the bench's batches (CUDA events), each decoding a B=16
    batch on the card as on the host CPU (full outputs); the link step's
    profile.  Polar has no kernel: nothing of K1-K5 runs here."""
    from commpy_tpu_torch.models import make_polar_awgn_link
    from commpy_tpu_torch.ops import polar as PP

    dev = torch.device("cuda")
    plain = PP.polar_construct(1024, 512, design_snr_db=2.0)
    code = PP.polar_construct(1024, 512, crc="crc11", design_snr_db=2.0)
    link = make_polar_awgn_link(code=code, decoder="scl", list_size=8,
                                modulation_m=4)
    sc_link = make_polar_awgn_link(code=plain, decoder="sc", modulation_m=4)
    # the links' SNR is the JAX package's: Es/N0 = rate * snr, so with QPSK
    # snr = Eb/N0 + 10 log10(2)
    snr_2, snr_6, snr_m1 = (db + 10 * np.log10(2) for db in (2.0, 6.0, -1.0))
    t0 = time.perf_counter()
    res = mc(link, [snr_2], 90, 512, 2)
    mc_s = time.perf_counter() - t0
    e6 = step_errors(torch, link, 512, snr_6, 91)
    em1 = step_errors(torch, link, 512, snr_m1, 92)
    # the same payload bits and noise through both links (same shapes)
    bits, llr_scl = link_receive(torch, link, 512, snr_2, 93)
    bits_sc, llr_sc = link_receive(torch, sc_link, 512, snr_2, 93)
    if not torch.equal(bits, bits_sc):
        fail("Path M: the SC and SCL links drew different bits")
    sc_dec = sc_link.decode(llr_sc)
    fe_scl = int((link.decode(llr_scl) != bits).any(-1).sum())
    fe_sc = int((sc_dec != bits).any(-1).sum())
    list1 = {
        "unrolled": PP.polar_scl_decode(plain, llr_sc, list_size=1),
        "scan": PP.make_polar_scl_decoder(plain, list_size=1,
                                          device=dev)(llr_sc)}
    list1_differ = {k: int((v != sc_dec).sum()) for k, v in list1.items()}
    out = {"ber_2db": float(res.bers[0]), "bits_sent": float(
        res.bits_sent[0]), "rounds": res.rounds, "mc_s": mc_s,
        "errs_6db": e6, "errs_m1db": em1,
        "frame_errors_2db": {"scl8_crc11": fe_scl, "sc": fe_sc},
        "list1_vs_sc_bits_differ": list1_differ}
    print(f"Path M polar (1024, 512) QPSK SCL-8 + CRC-11, F=512: BER "
          f"{res.bers[0]:.4e} at Eb/N0 2 dB ({res.rounds} steps, "
          f"{mc_s:.1f} s); errors {e6} at Eb/N0 6 dB, {em1} at -1 dB; frame "
          f"errors at 2 dB on the same draws SCL-8 + CRC-11 {fe_scl}, SC {fe_sc}; "
          f"SCL with one path vs SC bits differ {list1_differ}", flush=True)
    if not e6 == 0 < em1 or em1 < 0.01 * 512 * 512:
        fail(f"Path M: {e6} errors at 6 dB, {em1} at -1 dB")
    if not fe_scl < fe_sc:
        fail(f"Path M: SCL-8 + CRC-11 frame errors {fe_scl}, SC {fe_sc}")
    if any(list1_differ.values()):
        fail(f"Path M: SCL with one path differs from SC {list1_differ}")
    # the decoders at the JAX bench's batches, randn * 3 LLRs
    rng = np.random.RandomState(94)
    rows = {}
    for key, cd, B, make in (
            ("sc_b2048", plain, 2048,
             lambda d, **kw: PP.make_polar_sc_decoder(plain, device=d, **kw)),
            ("scl8_crc11_scan_b256", code, 256,
             lambda d, **kw: PP.make_polar_scl_decoder(
                 code, list_size=8, device=d, **kw)),
            ("scl8_crc11_unrolled_b1024", code, 1024,
             lambda d, **kw: PP.make_polar_scl_decoder_unrolled(
                 code, list_size=8, device=d, **kw))):
        x = torch.as_tensor(rng.randn(B, 1024).astype(np.float32) * 3,
                            device=dev)
        dec = make(dev)
        t0 = time.perf_counter()
        dec(x)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        ms = cuda_ms(torch, lambda: dec(x), 2)
        card = make(dev, full=True)(x[:16])
        host = make("cpu", full=True)(x[:16].cpu())
        card = card if isinstance(card, tuple) else (card,)
        host = host if isinstance(host, tuple) else (host,)
        differ = sum(int((a.cpu() != b).sum()) for a, b in zip(card, host))
        rows[key] = {"B": B, "ms": ms, "first_call_s": first_s,
                     "info_bits_per_s": B * 512 / (ms * 1e-3),
                     "card_vs_host_b16_values_differ": differ}
        print(f"Path M decoder {key}: {ms:.2f} ms a call (CUDA events), "
              f"{B * 512 / (ms * 1e-3):.4g} info bits/s; card vs host on "
              f"B=16, full outputs: {differ} values differ", flush=True)
        if differ:
            fail(f"Path M: {key} decodes differently on the card and the "
                 "host")
    out["decoders"] = rows
    # SC's block size at B=2048: the same decisions at every size; the
    # decode is host-paced, so each size is timed once a round over 8
    # rounds in turns (the order reversed every other round), and its
    # launches are counted from one profiled decode
    x = torch.as_tensor(rng.randn(2048, 1024).astype(np.float32) * 3,
                        device=dev)
    want = PP.make_polar_sc_decoder(plain, device=dev)(x)
    sizes = (5, 6, 7, 8, 9, 10)
    decs = {be: PP.make_polar_sc_decoder(plain, block_exp=be, device=dev)
            for be in sizes}
    for be, dec in decs.items():
        if not torch.equal(dec(x), want):
            fail(f"Path M: SC with block_exp {be} decodes differently")
    runs = {be: [] for be in sizes}
    for r in range(8):
        for be in (sizes if r % 2 == 0 else sizes[::-1]):
            runs[be].append(cuda_ms(torch, lambda: decs[be](x), 1, 0))
    sweep = {be: {"median_ms": float(np.median(v)), "min_ms": min(v),
                  "max_ms": max(v),
                  "launches": device_launches(torch, lambda: decs[be](x))}
             for be, v in runs.items()}
    out["sc_b2048_block_exp"] = sweep
    print(f"Path M SC B=2048 by block_exp (median [min - max] ms a call of "
          f"8 in turns, CUDA events; launches a decode; default "
          f"{PP.SC_BLOCK_EXP}): " + ", ".join(
              f"{be}: {v['median_ms']:.2f} [{v['min_ms']:.2f} - "
              f"{v['max_ms']:.2f}] {v['launches']}"
              for be, v in sweep.items()), flush=True)
    out["timing"] = time_link(torch, link, 512, snr_2, 95,
                              "Path M polar SCL-8 + CRC-11")
    report["path_m"] = out


def idd_path(torch, report):
    """Path N: the IDD K-best LDPC MIMO link at the reference's anchor
    configuration (``tests/test_idd_parity.py:165-195``): WiMAX (1440,
    720), 4x4 16-QAM, K-best(16) soft with priors, MSA-15, one exchange,
    F=512 (46,080 vectors a step), through ``montecarlo_ber`` at 17, 18 and
    19 dB with K4's count set to 0 just before and read just after (two
    decodes a step); K4 on the LLRs the loop hands its decoder and its
    decision, against its plain version; the step's profile.  Returns
    {kernel: {path: launches}}."""
    from commpy_tpu_torch.kernels import qc_bp as QK
    from commpy_tpu_torch.models import (idd_decoder_device,
                                         make_idd_kbest_ldpc_mimo_link)
    from commpy_tpu_torch.ops import ldpc as L

    wimax = L.get_ldpc_code_params(os.path.join(L.DESIGNS, "wimax",
                                                "1440.720.txt"), True)
    link = make_idd_kbest_ldpc_mimo_link(ldpc_params=wimax, beam=16, n_it=1)
    snrs = [17.0, 18.0, 19.0]
    QK.qc_bp_resident.launches = 0
    res = mc(link, snrs, 100, 512, 2)
    launches = QK.qc_bp_resident.launches
    bers = [float(b) for b in res.bers]
    desired = np.array([1.7e-1, 1e-1, 2.5e-3])
    steps = res.rounds * len(snrs)
    tally = QCTally()
    bits, noise, h = link_draws(torch, link, 512, 101)
    rx = link.receive(bits, noise, float(link.noise_std_fn(18.0)), h)
    seen = []

    def capture(fn):
        def run(llrs):
            seen.append(llrs)
            return fn(llrs)
        return run

    ex = link.extras
    idd_decoder_device(ex["detector"], capture(ex["decoder"]),
                       capture(ex["decision"]), 1)(*rx)
    for llrs in seen:
        k4_on(torch, wimax["_qc_lift"], llrs.reshape(512, -1), tally)
    out = {"bers": bers, "snrs_db": snrs, "reference": desired.tolist(),
           "bits_sent": float(res.bits_sent[0]), "steps": steps,
           "launches": launches,
           "k4_on_loop_llrs": {"mismatches": tally.mismatches,
                               "cases": tally.cases,
                               "compared": tally.compared}}
    print(f"Path N IDD K-best(16) + WiMAX LDPC MSA-15, n_it=1, F=512: BER "
          f"{bers} at 17/18/19 dB (reference {desired.tolist()}, rtol 2, at "
          f"most 1.5x); qc_bp_resident launches {launches} in {steps} "
          f"steps; K4 on the loop's decoder and decision LLRs: "
          f"{tally.mismatches} mismatches in {tally.cases} cases, "
          f"{tally.compared} decisions", flush=True)
    if not (np.all(np.abs(np.array(bers) - desired) <= 2 * desired)
            and np.all(np.array(bers) <= 1.5 * desired)):
        fail(f"Path N BER {bers} is off the reference curve")
    if launches != 2 * steps:
        fail(f"Path N launched qc_bp_resident {launches} times in {steps} "
             "steps, not twice a step")
    if tally.mismatches or len(seen) != 2:
        fail(f"Path N: K4 disagrees with its plain version on the loop's "
             f"LLRs ({tally.mismatches} of {tally.compared})")
    out["timing"] = time_link(torch, link, 512, 18.0, 102,
                              "Path N IDD K-best LDPC MIMO")
    require_kernels(out["timing"], "Path N", ["qc_bp_resident_kernel"])
    report["path_n"] = out
    return {"qc_bp_resident": {"N": launches}}


def api_path(torch, report):
    """Path O: the CommPy-compatible API on the card.  ``Wifi80211(4)``'s
    host loop over a ``SISOFlatChannel`` at 12 dB (1200-bit chunks until
    2,000 bit errors or 400 chunks) against the batched 802.11 link's
    MCS-4 BER at the same noise_std, with K1/K2's counts, and K1/K2
    against their plain versions on the depunctured LLRs of its first
    chunks (B=1, the decoder's own tb_depth), each chunk's decoded bits
    against the plain route's; one ``channelcoding.turbo_decode`` call
    (K3) against the torch route's bits, and each of its K3 calls' outputs
    against the plain version on that call's inputs;
    ``LinkModel.link_performance_device`` for uncoded QPSK against
    ``erfc(sqrt(snr/2))/2``; the host loops' time a chunk.
    Returns {kernel: {path: launches}}."""
    import commpy_tpu_torch.channelcoding as CC
    from commpy_tpu_torch.channelcoding import convcode as CCV
    from commpy_tpu_torch.channels import SISOFlatChannel
    from commpy_tpu_torch.kernels import bcjr as BK
    from commpy_tpu_torch.kernels import viterbi_acs as K
    from commpy_tpu_torch.links import LinkModel
    from commpy_tpu_torch.models import wifi80211_device_link
    from commpy_tpu_torch.ops import modem as M
    from commpy_tpu_torch.ops import turbo as TU
    from commpy_tpu_torch.ops.turbo import turbo_decode_device
    from commpy_tpu_torch.utils.device import on_device
    from commpy_tpu_torch.wifi80211 import Wifi80211
    from scipy.special import erfc

    launches = {"acs_forward": {}, "traceback": {}, "bcjr_appdiff": {}}
    np.random.seed(110)
    channel = SISOFlatChannel(fading_param=(1 + 0j, 0))
    # the first chunks' decoder inputs and decoded bits, as the host loop
    # hands them to the compatible viterbi_decode
    seen, vd = [], CCV.viterbi_decode

    def capture(msg_d, trellis, *args, **kw):
        out = vd(msg_d, trellis, *args, **kw)
        if len(seen) < 8:
            seen.append((msg_d, trellis, out))
        return out

    K.acs_forward.launches = K.traceback.launches = 0
    CCV.viterbi_decode = capture
    try:
        t0 = time.perf_counter()
        BERs, BEs, _, NCs = Wifi80211(4).link_performance(
            channel, [12.0], 400, 2000, send_chunk=1200)
        wifi_s = time.perf_counter() - t0
    finally:
        CCV.viterbi_decode = vd
    chunks = int(NCs.sum())
    errs = int(BEs.sum())
    for kern in (K.acs_forward, K.traceback):
        launches[kern.__name__]["O"] = kern.launches
        if not kern.launches:
            fail(f"Path O never launched {kern.__name__}")
    # K1/K2 on those chunks at the path's shape (B=1, tb_depth as the
    # decoder sets it), and each chunk's bits against the plain route
    k12 = {"acs_forward": [0, 0], "traceback": [0, 0]}
    for msg_d, trellis, out in seen:
        rx = on_device(np.asarray(msg_d, dtype=float), "cuda")[None]
        L = rx.shape[-1] * trellis.k // trellis.n
        got = viterbi_parity(torch, rx, trellis, L,
                             min(5 * trellis.total_memory, L),
                             "Path O", decoded=out[None])
        for name, (bad, n) in got.items():
            k12[name][0] += bad
            k12[name][1] += n
    if len(seen) < 8:
        fail(f"Path O decoded {len(seen)} chunks, fewer than the 8 compared")
    dl = wifi80211_device_link(4, frame_bits=1200)
    ns_dl = float(dl.noise_std_fn(12.0))
    res = mc(dl, [12.0], 111, 2048, 2)
    ratio = float(BERs[0] / res.bers[0])
    wifi = {"ber": float(BERs[0]), "bit_errors": errs, "chunks": chunks,
            "chunk_bits": 1200, "s": wifi_s, "ms_per_chunk":
            wifi_s / chunks * 1e3, "noise_std": float(channel.noise_std),
            "device_link_noise_std": ns_dl,
            "device_link_ber": float(res.bers[0]),
            "device_link_bits": float(res.bits_sent[0]), "ratio": ratio,
            "launches": {k: v["O"] for k, v in launches.items() if v},
            "k1_k2_on_chunks": {"chunks": len(seen), **{
                k: {"mismatches": v[0], "compared": v[1]}
                for k, v in k12.items()}}}
    print(f"Path O Wifi80211(4).link_performance at 12 dB: BER "
          f"{BERs[0]:.4e} ({errs} errors in {chunks} chunks of 1200 bits, "
          f"{wifi['ms_per_chunk']:.2f} ms a chunk); batched MCS-4 link BER "
          f"{res.bers[0]:.4e}, ratio {ratio:.3f}; noise_std "
          f"{channel.noise_std:.9f} vs {ns_dl:.9f}; launches "
          f"{wifi['launches']}; K1/K2 vs plain on {len(seen)} chunks' "
          f"LLRs (B=1) and their decoded bits {wifi['k1_k2_on_chunks']}",
          flush=True)
    if abs(channel.noise_std - ns_dl) > 1e-6 * ns_dl:
        fail(f"Path O: the SNR conventions give noise_std "
             f"{channel.noise_std} and {ns_dl}")
    if errs < 200 or abs(ratio - 1) > 0.25:
        fail(f"Path O: compatible BER {BERs[0]} ({errs} errors) vs the "
             f"batched link's {res.bers[0]}")
    # one reference-compatible turbo decode on the card (K3)
    # L=1024: the torch route it is held to walks the frame step by step
    trt = rsc_trellises()[1][1]
    il = CC.RandInterlv(1024, 0)
    rng = np.random.RandomState(112)
    msg = rng.randint(0, 2, 1024)
    streams = CC.turbo_encode(msg, trt, trt, il)
    nv = 1 / (2 * (1 / 3) * 10 ** (1.0 / 10))
    ys = [2.0 * np.asarray(s[:1024], float) - 1.0
          + rng.randn(1024) * np.sqrt(nv) for s in streams]
    # each K3 call's inputs and output, as the decoder makes them
    k3_calls, k3 = [], TU.bcjr_appdiff

    def record(*args, **kw):
        out = k3(*args, **kw)
        k3_calls.append((args, kw, out))
        return out

    BK.bcjr_appdiff.launches = 0
    TU.bcjr_appdiff = record
    try:
        t0 = time.perf_counter()
        dec = CC.turbo_decode(*ys, trt, nv, 8, il)
        turbo_s = time.perf_counter() - t0
    finally:
        TU.bcjr_appdiff = k3
    launches["bcjr_appdiff"]["O"] = BK.bcjr_appdiff.launches
    tally = K3Tally()
    for args, kw, out in k3_calls:
        exact = not kw.get("max_log") and kw.get("lse") in (None, "exact")
        tally.add((out,), (BK.bcjr_appdiff_plain(*args, **kw),), exact)
    plain = turbo_decode_device(*ys, trt, nv, 8, il.p_array,
                                backend="torch").cpu().numpy()
    turbo = {"differ": int((dec != plain).sum()),
             "ber": float((dec != msg).mean()), "s": turbo_s,
             "launches": launches["bcjr_appdiff"]["O"],
             "k3_on_calls": {"calls": len(k3_calls), "cases": tally.cases,
                             "mismatches": tally.mismatches,
                             "bit_diffs": tally.bit_diffs,
                             "compared": tally.compared,
                             "max_abs_err": tally.max_abs_err}}
    print(f"Path O channelcoding.turbo_decode L=1024, 8 iterations, Eb/N0 "
          f"1.0 dB: {turbo}", flush=True)
    if (turbo["differ"] or not turbo["launches"] or tally.mismatches
            or len(k3_calls) != turbo["launches"]):
        fail(f"Path O: turbo_decode on the card {turbo}")
    # the device sweep and the host loop, uncoded QPSK
    const = M.qam_constellation(4).astype(np.complex64)

    def model():
        return LinkModel(
            lambda b: M.modulate(b, const, 2),
            SISOFlatChannel(fading_param=(1 + 0j, 0)),
            lambda y, h, c, nv: M.demodulate_hard(y, const, 2), 2, const,
            2.0)

    snrs = np.arange(0, 9, 2.0)
    t0 = time.perf_counter()
    bers = model().link_performance_device(snrs, 10 ** 6, 1000, 1000,
                                           frames_per_round=64)
    dev_s = time.perf_counter() - t0
    theory = erfc(np.sqrt(10 ** (snrs / 10) / 2)) / 2
    host = model()
    host.modulate = lambda b: M.modulate(b, const, 2).cpu().numpy()
    host.receive = (lambda y, h, c, nv: M.demodulate_hard(
        torch.as_tensor(y, device="cuda"), const, 2).cpu().numpy())
    t0 = time.perf_counter()
    host_bers = host.link_performance([6.0], 50_000, 10 ** 9, 1000)
    host_s = time.perf_counter() - t0
    qpsk = {"snrs_db": snrs.tolist(), "bers": bers.tolist(),
            "theory": theory.tolist(), "s": dev_s,
            "host_loop_ber_6db": float(host_bers[0]),
            "host_loop_ms_per_chunk": host_s / 50 * 1e3}
    print(f"Path O LinkModel.link_performance_device uncoded QPSK: BER "
          f"{bers.tolist()} vs erfc {theory.tolist()} ({dev_s:.1f} s); host "
          f"loop at 6 dB BER {host_bers[0]:.4e}, "
          f"{qpsk['host_loop_ms_per_chunk']:.2f} ms a 1000-bit chunk",
          flush=True)
    if not np.allclose(bers, theory, rtol=0.25):
        fail(f"Path O: uncoded QPSK {bers} vs {theory}")
    report["path_o"] = {"wifi80211": wifi, "turbo_decode": turbo,
                        "qpsk_link_performance_device": qpsk}
    return launches


def profile_call(torch, fn, step_s, label, steps=2):
    """:func:`profile_link_step` of a call that is not a link step."""
    import types

    shim = types.SimpleNamespace(link_step=lambda g, frames, ns: fn())
    return profile_link_step(torch, shim, None, None, step_s, steps=steps,
                             label=label)


def host_step_s(torch, fn, reps=3):
    """Host-clock seconds of one call of ``fn``, the device drained, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def dp_path(torch, report, link, main_res, uncoded_2db, k7):
    """Path P: the data-parallel engine at world size 1 over NCCL.

    ``montecarlo_ber`` with ``mesh=make_mesh()`` on the MCS-4 link at
    F=2048, 12 dB (the main path's configuration and seed): its tallies
    equal the main path's, and each round's the mesh-less round's,
    exactly; K1 and K2 counted.  Through the mesh: uncoded QPSK against
    erfc (rtol 0.25), K=7 soft at 2 dB ten times under the uncoded curve,
    ``errs(35 dB) == 0 < errs(5 dB)`` on MCS-4, and one
    ``LinkModel.link_performance_device(mesh=...)`` equal to ``mesh=None``.
    Returns {kernel: {"P": launches}}."""
    from commpy_tpu_torch.channels import SISOFlatChannel
    from commpy_tpu_torch.kernels import viterbi_acs as K
    from commpy_tpu_torch.links import LinkModel
    from commpy_tpu_torch.models.device_links import make_conv_awgn_link
    from commpy_tpu_torch.ops import modem as M
    from commpy_tpu_torch.ops.channel import snr_to_noise_std
    from commpy_tpu_torch.parallel import (distributed, make_mesh,
                                           make_round_fn, montecarlo_ber)
    from scipy.special import erfc

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    mesh = make_mesh()  # NCCL, a world of one
    distributed_init_s = time.perf_counter() - t0
    info = distributed.process_info()
    K.acs_forward.launches = K.traceback.launches = 0
    res = montecarlo_ber(link.link_step, [12.0], link.noise_std_fn,
                         link.frame_bits, seed=1, frames_per_round=2048,
                         max_rounds=3, err_min=10 ** 9, device="cuda",
                         mesh=mesh)
    launches = {"acs_forward": {"P": K.acs_forward.launches},
                "traceback": {"P": K.traceback.launches}}
    print(f"Path P MCS-4 F=2048 at 12 dB over make_mesh() (NCCL, world "
          f"{info[1]}): {res.rounds} rounds, BER {res.bers[0]:.3e}, "
          f"{res.bit_errors[0]:.0f} errors (main path "
          f"{main_res.bit_errors[0]:.0f}); launches {launches}", flush=True)
    if not np.array_equal(res.bit_errors, main_res.bit_errors) or \
            not np.array_equal(res.bits_sent, main_res.bits_sent):
        fail("Path P: the mesh's tallies differ from the main path's")
    if not all(v["P"] for v in launches.values()):
        fail(f"Path P never launched a kernel: {launches}")
    ns = [float(link.noise_std_fn(12.0))]
    rf_mesh = make_round_fn(link.link_step, ns, 2048, "cuda", mesh)
    rf_solo = make_round_fn(link.link_step, ns, 2048, "cuda")
    per_round = [(rf_mesh(1, r).tolist(), rf_solo(1, r).tolist())
                 for r in range(3)]
    if any(a != b for a, b in per_round):
        fail(f"Path P: mesh and mesh-less rounds differ: {per_round}")
    step_mesh = host_step_s(torch, lambda: rf_mesh(1, 0))
    step_solo = host_step_s(torch, lambda: rf_solo(1, 0))
    # what every rank repeats: the round's whole draw (bits and noise)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    draw_ms = cuda_ms(torch, lambda: link.draw(g, 2048), 10)
    prof = profile_call(torch, lambda: rf_mesh(1, 0), step_mesh,
                        "Path P MCS-4 round over the mesh")
    # physics through the mesh
    qpsk = M.qam_constellation(4).astype(np.complex64)

    def uncoded_step(gen, frames, noise_std, rows=None):
        bits = torch.randint(0, 2, (frames, 1000), generator=gen, device=dev,
                             dtype=torch.int8)
        z = torch.randn((2, frames, 500), generator=gen, device=dev)
        if rows is not None:
            bits, z = bits[rows], z[:, rows]
        y = M.modulate(bits, qpsk, 2) + torch.complex(z[0], z[1]) * (
            noise_std * 0.5)
        return torch.sum(M.demodulate_hard(y, qpsk, 2) ^ bits,
                         dtype=torch.int32)

    snrs = np.arange(0, 9, 2.0)
    unc = montecarlo_ber(uncoded_step, snrs,
                         lambda s: snr_to_noise_std(s, Es=2.0), 1000, seed=2,
                         frames_per_round=256, max_rounds=20, err_min=400,
                         device="cuda", mesh=mesh)
    theory = erfc(np.sqrt(10 ** (snrs / 10) / 2)) / 2
    coded = make_conv_awgn_link(trellis=k7, modulation_m=2, frame_bits=1000,
                                decoding_type="soft", device="cuda")
    cod = montecarlo_ber(coded.link_step, [2.0], coded.noise_std_fn, 1000,
                         seed=3, frames_per_round=512, max_rounds=8,
                         err_min=200, device="cuda", mesh=mesh)
    errs = {db: int(make_round_fn(link.link_step,
                                  [float(link.noise_std_fn(db))], 256,
                                  "cuda", mesh)(4, 0)[0])
            for db in (35.0, 5.0)}
    const = M.qam_constellation(4).astype(np.complex64)

    def model():
        return LinkModel(
            lambda b: M.modulate(b, const, 2),
            SISOFlatChannel(fading_param=(1 + 0j, 0)),
            lambda y, h, c, nv: M.demodulate_hard(y, const, 2), 2, const,
            2.0)

    lpd = model().link_performance_device([0.0, 4.0], 64_000, 10 ** 6, 1000,
                                          frames_per_round=16, mesh=mesh)
    lpd_solo = model().link_performance_device([0.0, 4.0], 64_000, 10 ** 6,
                                               1000, frames_per_round=16)
    print(f"Path P physics over the mesh: uncoded QPSK BER "
          f"{unc.bers.tolist()} vs erfc {theory.tolist()}; K=7 soft 2 dB "
          f"{cod.bers[0]:.3e} vs uncoded {uncoded_2db:.3e}; MCS-4 errors "
          f"{errs}; link_performance_device {lpd.tolist()} (mesh=None "
          f"{lpd_solo.tolist()}); round {step_mesh * 1e3:.3f} ms over the "
          f"mesh, {step_solo * 1e3:.3f} ms without, the draw "
          f"{draw_ms:.4f} ms; process group and "
          f"mesh {distributed_init_s:.2f} s", flush=True)
    if not np.allclose(unc.bers, theory, rtol=0.25):
        fail("Path P: uncoded QPSK BER over the mesh does not match erfc")
    if not (cod.bit_errors[0] > 0 and cod.bers[0] * 10 < uncoded_2db):
        fail("Path P: K=7 soft does not beat uncoded QPSK by 10x at 2 dB")
    if not errs[35.0] == 0 < errs[5.0]:
        fail("Path P: MCS-4 fails errs(35 dB) == 0 < errs(5 dB)")
    if not np.array_equal(lpd, lpd_solo):
        fail("Path P: link_performance_device over the mesh differs")
    report["path_p"] = {
        "world": info, "process_group_and_mesh_s": distributed_init_s,
        "bit_errors": res.bit_errors.tolist(), "ber": res.bers.tolist(),
        "per_round": per_round, "launches": launches,
        "round_ms_mesh": step_mesh * 1e3, "round_ms_no_mesh": step_solo * 1e3,
        "draw_ms": draw_ms,
        "info_bits_per_s": 2048 * 1200 / step_mesh, "profile": prof,
        "uncoded_qpsk_ber": unc.bers.tolist(), "k7_soft_2db_ber":
            float(cod.bers[0]), "mcs4_errs": {str(k): v for k, v in
                                              errs.items()},
        "link_performance_device": lpd.tolist()}
    return launches


def stack_k3_calls(torch, BK, calls):
    """K3's outputs on ``calls`` (``(args, kwargs, output)`` of one-lane
    calls of one shape) side by side, and its plain version's on the same
    inputs, stacked along the lane axis."""
    def lanes(xs):
        return torch.cat(list(xs), dim=-1)

    args = [lanes(c[0][i] for c in calls) for i in range(3)]
    kw = dict(calls[0][1])
    if "valid" in kw:
        kw["valid"] = lanes(c[1]["valid"] for c in calls)
        kw["first"] = lanes(c[1]["first"] for c in calls)
    if "boundary" in kw:
        kw["boundary"] = tuple(lanes(c[1]["boundary"][i] for c in calls)
                               for i in range(2))
    outs = [c[2] if isinstance(c[2], tuple) else (c[2],) for c in calls]
    got = tuple(lanes(o[i] for o in outs) for i in range(len(outs[0])))
    want = BK.bcjr_appdiff_plain(*args, calls[0][0][3], **kw)
    return got, want if isinstance(want, tuple) else (want,)


def record_calls(module, names, fn, keep=None):
    """Run ``fn`` with each ``module.name`` wrapped to record its calls
    (the first ``keep`` of each, or all): returns {name: [(args, kwargs,
    output), ...]}."""
    calls = {name: [] for name in names}
    real = {name: getattr(module, name) for name in names}

    def recorder(name):
        def call(*a, **kw):
            out = real[name](*a, **kw)
            if keep is None or len(calls[name]) < keep:
                calls[name].append((a, kw, out))
            return out
        return call

    for name in names:
        setattr(module, name, recorder(name))
    try:
        fn()
    finally:
        for name in names:
            setattr(module, name, real[name])
    return calls


def stream_k1_k2_full(torch, calls):
    """K1 and K2 on the words the 2^20 stream decoded (its recorded calls):
    K2 against its plain version on the card, K1 against its plain
    version on the host (on the card the plain ACS is launch-bound at
    ~0.35 ms a step, minutes at 2^20 steps; the host's per-step ops are
    cheaper).  Returns the tallies and what the check took."""
    from commpy_tpu_torch.kernels import viterbi_acs as K

    (acs_a, _, (dec, best)), = calls["acs_forward"]
    (tb_a, _, bits), = calls["traceback"]
    r, C, hc = (acs_a + (None,))[:3]
    _, _, S, tbd = tb_a
    tally = {"acs_forward": Tally(), "traceback": Tally()}
    tally["traceback"].add(bits, K.traceback_plain(dec, best, S, tbd))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        dec_h, best_h = K.acs_forward_plain(
            r.cpu(), C.cpu(), None if hc is None else hc.cpu())
    host_s = time.perf_counter() - t0
    tally["acs_forward"].add(dec.cpu(), dec_h)
    tally["acs_forward"].add(best.cpu(), best_h)
    B, T, _ = r.shape
    return tally, {"T": T, "B": B, "host_plain_acs_s": host_s,
                   "k2_plan": K.traceback_plan(S, T, tbd, B)}


def k3_vs_bcjr_masked(torch, ST, passes):
    """The kernel route's MAP passes (``_map_pass`` calls recorded in one
    decode) against ``_bcjr_masked`` on the same inputs, all passes as
    rows of one host call.  The route runs K3 renormalising every
    ``STREAM_RENORM_EVERY`` steps, so e follows the per-step normalised
    reference within 1e-5 (1 + |want|) at any window length
    (``test_torch_stream.py`` holds it from T = 288 to 6144); a value
    fails past that, or past 4 eps Gamma (Gamma = the sum over valid
    steps of (|sy| + |pa|) / nv + |li|, the bound an unrenormalised K3
    held), or on another decision where the reference is past either
    bound; carries are compared up to their constant offset within the
    same tolerances."""
    a0, kw0, _ = passes[0]
    nv, inv_nv, trellis, max_log = a0[4], a0[5], a0[6], a0[7]

    def rows(get):
        return torch.stack([get(p) for p in passes]).cpu()

    sy, pa, li = (rows(lambda p, i=i: p[0][i]) for i in (1, 2, 3))
    R, Wn = sy.shape
    nii = kw0.get("boundary") is not None
    valid = (torch.ones((R, Wn), dtype=torch.bool) if nii
             else rows(lambda p: p[1]["valid"]))
    first = torch.cat([p[1]["first"] for p in passes]).cpu()
    init = ({"alpha_init": rows(lambda p: p[1]["boundary"][0]),
             "beta_init": rows(lambda p: p[1]["boundary"][1]),
             "return_carries": True} if nii else {})
    t0 = time.perf_counter()
    out = ST._bcjr_masked(sy, pa, li, nv, trellis, valid, first, max_log,
                          **init)
    host_s = time.perf_counter() - t0
    apps = out[0] if nii else out
    want = (apps[..., 1] - apps[..., 0],) + (tuple(out[1:]) if nii else ())
    got = tuple(rows(lambda p, i=i: p[2][i] if nii else p[2])
                for i in range(len(want)))
    gamma = torch.where(valid, (sy.abs() + pa.abs()) * inv_nv + li.abs(),
                        torch.zeros(())).sum(1)
    bound = 4 * float(np.finfo(np.float32).eps) * gamma  # [R]
    tol = 1e-5 * (1 + want[0].abs())  # [R, Wn]
    dev_e = (got[0] - want[0]).abs()
    rel_c, abs_c = [], []
    for g, w in zip(got[1:], want[1:]):
        wc = w - w.amax(1, keepdim=True)
        d = ((g - g.amax(1, keepdim=True)) - wc).abs()
        abs_c.append(d.amax(1))
        rel_c.append((d / (1 + wc.abs())).amax(1))
    over = (dev_e.amax(1) > bound).sum() + sum(
        (c > bound).sum() for c in abs_c)
    flips = (got[0] > 0) != (want[0] > 0)
    return {"passes": R, "window": Wn, "values": dev_e.numel(),
            "max_abs_dev": float(dev_e.max()),
            "max_rel_dev": float((dev_e / (1 + want[0].abs())).max()),
            "values_over_1e-5": int((dev_e > tol).sum()),
            "carry_max_rel_dev": [float(c.max()) for c in rel_c],
            "max_dev_over_eps_gamma": float(
                (dev_e.amax(1) / (bound / 4)).max()),
            "bound_4_eps_gamma": [float(bound.min()), float(bound.max())],
            "carry_max_dev": [float(c.max()) for c in abs_c],
            "sign_differs": int(flips.sum()),
            "sign_differs_past_bound": int((flips & (
                (want[0].abs() > bound[:, None]) | (want[0].abs() > tol))
            ).sum()),
            "passes_over_bound": int(over), "host_s": host_s}


def stream_path(torch, report, k7):
    """Path Q: the sequence-parallel streams at world size 1 over NCCL.

    The Viterbi stream of 2^20 info bits (K=7 soft BPSK, Eb/N0 3 dB,
    tb_depth 30, warmup 128): bits equal ``viterbi_decode_device`` on the
    same extended window, BER ten times under uncoded BPSK, K1/K2 counted
    and held bit for bit to their plain versions on the stream's own
    window (K2's device-memory plan) and on a 4,096-bit stream (its staged
    plan).  The turbo stream (4-state (1, 7/5) RSC, L=6144, 8 log-MAP
    iterations, Eb/N0 2.0 dB, 8 frames) in both ``boundary_init`` modes:
    BER under 1e-4, K3 counted; on every MAP pass of one decode in each
    mode, K3 against its plain version (``K3Tally``) and against
    ``_bcjr_masked``, the JAX package's masked core, within
    1e-5 (1 + |x|) (:func:`k3_vs_bcjr_masked`).
    Returns {kernel: {"Q": launches}}."""
    from commpy_tpu_torch.kernels import bcjr as BK
    from commpy_tpu_torch.kernels import viterbi_acs as K
    from commpy_tpu_torch.ops import stream as ST
    from commpy_tpu_torch.ops.convcode import encode_scan
    from commpy_tpu_torch.ops.interleave import RandInterlv
    from commpy_tpu_torch.ops.turbo import turbo_encode_device
    from commpy_tpu_torch.ops.viterbi import (received_words,
                                              viterbi_decode_device)
    from commpy_tpu_torch.parallel import make_mesh
    from scipy.special import erfc

    dev = torch.device("cuda")
    mesh = make_mesh(axis_name="sp")
    rng = np.random.RandomState(120)
    L, W, tb = 1 << 20, 128, 30
    msg = torch.as_tensor(rng.randint(0, 2, (1, L)).astype(np.int8),
                          device=dev)
    coded = encode_scan(msg, k7)[0][0]
    nv = 1 / (2 * 0.5 * 10 ** 0.3)  # Eb/N0 3 dB at rate 1/2
    noise = torch.as_tensor(rng.randn(coded.numel()).astype(np.float32),
                            device=dev)
    llr = 2 * ((2.0 * coded.float() - 1) + noise * float(np.sqrt(nv))) / nv

    def vstream(x):
        return ST.sharded_viterbi_stream(x, k7, mesh, tb_depth=tb,
                                         warmup_codewords=W)

    K.acs_forward.launches = K.traceback.launches = 0
    bits = vstream(llr)
    torch.cuda.synchronize()
    launches = {"acs_forward": {"Q": K.acs_forward.launches},
                "traceback": {"Q": K.traceback.launches}}
    ext = torch.cat([torch.zeros(2 * W, device=dev), llr,
                     torch.zeros(2 * tb, device=dev)])
    ref = viterbi_decode_device(ext, k7, tb, "soft",
                                L=W + L + tb)[W:W + L]
    ber = float((bits != msg[0]).float().mean())
    uncoded = float(erfc(np.sqrt(10 ** 0.3)) / 2)
    v_step = host_step_s(torch, lambda: vstream(llr))
    v_prof = profile_call(torch, lambda: vstream(llr), v_step,
                          "Path Q Viterbi stream L=2^20")
    print(f"Path Q Viterbi stream L=2^20 K=7 soft Eb/N0 3 dB: BER {ber:.3e} "
          f"(uncoded {uncoded:.3e}); equal to the decode of its window: "
          f"{bool(torch.equal(bits, ref))}; {v_step * 1e3:.3f} ms, "
          f"{L / v_step:.4g} info bits/s; launches {launches}", flush=True)
    if not torch.equal(bits, ref):
        fail("Path Q: the Viterbi stream differs from viterbi_decode_device")
    if not (0 < ber * 10 < uncoded):
        fail(f"Path Q: Viterbi stream BER {ber} vs uncoded {uncoded}")
    if not all(v["Q"] for v in launches.values()):
        fail(f"Path Q: the Viterbi stream launched {launches}")
    # K1 and K2 on the words of the 2^20 stream's own decode
    from commpy_tpu_torch.ops import viterbi as OV
    full, full_info = stream_k1_k2_full(torch, record_calls(
        OV, ("acs_forward", "traceback"), lambda: vstream(llr)))
    print(f"Path Q K1/K2 on the 2^20 stream's window (T {full_info['T']}, "
          f"K2 staged {full_info['k2_plan']['staged']}): "
          f"{ {k: t.mismatches for k, t in full.items()} } mismatches in "
          f"{ {k: t.compared for k, t in full.items()} }; the host's plain "
          f"ACS took {full_info['host_plain_acs_s']:.1f} s", flush=True)
    for name, t in full.items():
        if t.mismatches or not t.compared:
            fail(f"Path Q: {name} disagrees with its plain version on the "
                 f"2^20-bit stream's window")
    # K1 and K2 on a 4,096-bit stream's words, against their plain versions
    small = llr[:2 * 4096]
    ext_s = torch.cat([torch.zeros(2 * W, device=dev), small,
                       torch.zeros(2 * tb, device=dev)])
    tally = {"acs_forward": Tally(), "traceback": Tally()}
    r = received_words(ext_s[None], k7, "soft", W + 4096 + tb)
    compare_case(torch, tally, k7, "soft", 1, W + 4096 + tb, tb, 0, r=r)
    if not torch.equal(vstream(small), viterbi_decode_device(
            ext_s, k7, tb, "soft", L=W + 4096 + tb,
            backend="torch")[W:W + 4096]):
        fail("Path Q: the 4,096-bit stream differs from the plain route")
    for name, t in tally.items():
        if t.mismatches:
            fail(f"Path Q: {name} disagrees with its plain version on the "
                 f"4,096-bit stream")
    # the turbo stream, both modes
    trt = rsc_trellises()[1][1]
    T = 6144
    p = RandInterlv(T, 0).p_array
    nvt = float(np.float32(1 / (2 * (1 / 3) * 10 ** 0.2)))  # Eb/N0 2 dB
    frames = []
    for f in range(8):
        m = torch.as_tensor(rng.randint(0, 2, (1, T)).astype(np.int8),
                            device=dev)
        x = 2.0 * torch.stack(turbo_encode_device(m, trt, trt, p)).to(
            torch.float32)[:, 0] - 1.0
        z = torch.as_tensor(rng.randn(3, T).astype(np.float32), device=dev)
        frames.append((m[0], x + z * float(np.sqrt(nvt))))

    def tstream(y, mode):
        return ST.sharded_turbo_stream(y[0], y[1], y[2], trt, nvt, 8, p, mesh,
                                       boundary_init=mode, warmup=64)

    turbo = {}
    k3_tally = K3Tally()
    for mode in ("warmup", "nii"):
        BK.bcjr_appdiff.launches = 0
        errs = sum(int((tstream(y, mode) != m).sum()) for m, y in frames)
        n_k3 = BK.bcjr_appdiff.launches
        launches.setdefault("bcjr_appdiff", {})
        launches["bcjr_appdiff"]["Q"] = launches["bcjr_appdiff"].get(
            "Q", 0) + n_k3
        step = host_step_s(torch, lambda: tstream(frames[0][1], mode))
        prof = profile_call(torch, lambda: tstream(frames[0][1], mode), step,
                            f"Path Q turbo stream {mode}")
        # every K3 call and MAP pass of one decode, recorded
        rec = record_calls(ST, ("bcjr_appdiff", "_map_pass"),
                           lambda: tstream(frames[0][1], mode))
        calls, passes = rec["bcjr_appdiff"], rec["_map_pass"]
        torch.cuda.synchronize()
        before = k3_tally.mismatches
        bits_before = k3_tally.bit_diffs
        # the plain version on all the passes at once, a lane a pass (its
        # arithmetic is lane by lane, so a lane computes as alone), at the
        # stream's renormalisation period
        if {c[1].get("renorm_every") for c in calls} != {
                ST.STREAM_RENORM_EVERY}:
            fail(f"Path Q: the stream's K3 calls do not renormalise every "
                 f"{ST.STREAM_RENORM_EVERY} steps")
        got, want = stack_k3_calls(torch, BK, calls)
        k3_tally.add(got, want, True)
        vs_masked = k3_vs_bcjr_masked(torch, ST, passes)
        turbo[mode] = {"frames": len(frames), "bit_errors": errs,
                       "ber": errs / (len(frames) * T),
                       "k3_launches": n_k3, "k3_calls_checked": len(calls),
                       "k3_mismatches": k3_tally.mismatches - before,
                       "k3_bit_diffs": k3_tally.bit_diffs - bits_before,
                       "renorm_every": ST.STREAM_RENORM_EVERY,
                       "step_s": step, "info_bits_per_s": T / step,
                       "profile": prof, "vs_bcjr_masked": vs_masked}
        print(f"Path Q turbo stream L=6144 {mode}, 8 iterations, Eb/N0 "
              f"2 dB: {errs} errors in {len(frames)} frames; K3 {n_k3} "
              f"launches; K3 against its plain version on {len(calls)} MAP "
              f"passes (renorm_every {ST.STREAM_RENORM_EVERY}): "
              f"{k3_tally.mismatches - before} mismatches, "
              f"{k3_tally.bit_diffs - bits_before} values differing in any "
              f"bit; every pass against _bcjr_masked {vs_masked}; "
              f"{step * 1e3:.3f} ms a frame (41.9-47.5 ms unrenormalised, "
              f"PERF.md's earlier reading on an H100 at 700 W)", flush=True)
        if errs / (len(frames) * T) >= 1e-4:
            fail(f"Path Q: turbo stream {mode} BER {errs / (len(frames) * T)}")
        if n_k3 != 16 * len(frames) or len(calls) != 16:
            fail(f"Path Q: turbo stream {mode} launched K3 {n_k3} times")
        if (k3_tally.mismatches != before
                or k3_tally.bit_diffs != bits_before):
            fail(f"Path Q: K3 disagrees with its plain version ({mode})")
        if (vs_masked["passes"] != 16 or vs_masked["passes_over_bound"]
                or vs_masked["values_over_1e-5"]
                or max(vs_masked["carry_max_rel_dev"], default=0) > 1e-5
                or vs_masked["sign_differs_past_bound"]):
            fail(f"Path Q: K3's route departs from _bcjr_masked past "
                 f"1e-5 (1 + |x|) or 4 eps Gamma ({mode}): {vs_masked}")
    report["path_q"] = {
        "viterbi": {"L": L, "ber": ber, "uncoded_ber": uncoded,
                    "step_s": v_step, "info_bits_per_s": L / v_step,
                    "profile": v_prof, "k1_k2_4096": {
                        k: {"compared": t.compared,
                            "mismatches": t.mismatches}
                        for k, t in tally.items()},
                    "k1_k2_full_window": dict(full_info, **{
                        k: {"compared": t.compared,
                            "mismatches": t.mismatches}
                        for k, t in full.items()})},
        "turbo": turbo, "k3_tally": {
            "cases": k3_tally.cases, "compared": k3_tally.compared,
            "mismatches": k3_tally.mismatches,
            "bit_diffs": k3_tally.bit_diffs,
            "max_rel_err": k3_tally.max_rel_err},
        "launches": launches}
    return launches


EXAMPLES = ("conv_encode_decode", "design_qc_ldpc", "dvbt_outer_chain",
            "ldpc_turbo_links", "nr_ldpc_rate_matching",
            "plot_constellations", "polar_ber", "receiver_frontend",
            "sharded_decoding", "wifi80211_bers")


def load_example(name):
    """``examples/torch/<name>.py`` of this checkout, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_example(name, out, host):
    """The checks of ``tests/test_torch_examples.py`` on a script's
    numbers at its default size: physics for the Monte-Carlo scripts
    (BER falls with SNR; soft no worse than hard and SCL-8 + CRC no worse
    than SC at the top point), and for the scripts whose draws are NumPy's
    the numbers of the same script run on the host (``host``), which that
    test holds to the JAX package's: exact for the decode counts and the
    BERs, each CFO estimate within 1e-4, the payload BER within 1e-3 and
    the CRC passes within 2 of 256 frames (the FFTs round apart).
    Returns a list of what failed."""
    bad = []

    def falls(label, bers):
        if not bers[0] > bers[-1]:
            bad.append(f"{label} BER does not fall with SNR: {bers}")

    if name in ("conv_encode_decode", "wifi80211_bers", "polar_ber"):
        for label, bers in out["bers"].items():
            falls(label, bers)
    if name == "conv_encode_decode":
        for code in ("K=3 (5,7)", "K=3 RSC", "K=7 (133,171)o"):
            if out["bers"][f"{code} soft"][-1] > \
                    out["bers"][f"{code} hard"][-1]:
                bad.append(f"{code}: soft worse than hard at the top SNR")
    if name == "polar_ber" and \
            out["bers"]["SCL-8+CRC11"][-1] > out["bers"]["SC"][-1]:
        bad.append("SCL-8 + CRC worse than SC at the top SNR")
    if name == "ldpc_turbo_links":
        for label, res in out.items():
            falls(label, res["bers"])
    if name == "plot_constellations" and not (
            os.path.getsize(out["path"]) > 10000 and out["points"] == {
                "8-PSK": 8, "16-QAM": 16, "64-QAM": 64}):
        bad.append(f"the constellation figure: {out}")
    if name in ("dvbt_outer_chain", "nr_ldpc_rate_matching",
                "design_qc_ldpc") and out != host:
        bad.append(f"the card's numbers {out} differ from the host's {host}")
    if name == "dvbt_outer_chain" and not (
            out["all_decoded"] and out["payload_exact"]
            and out["lost_without_interleaving"] > 0):
        bad.append(f"the outer chain: {out}")
    if name == "receiver_frontend" and not (
            np.abs(np.subtract(out["cfo"], host["cfo"])).max() <= 1e-4
            and abs(out["ber"] - host["ber"]) <= 1e-3
            and abs(out["crc_pass"] - host["crc_pass"]) <= 2):
        bad.append(f"the receiver's card and host numbers differ: BER "
                   f"{out['ber']} / {host['ber']}, CRC "
                   f"{out['crc_pass']} / {host['crc_pass']}")
    if name == "sharded_decoding" and not (
            out["ldpc_equal"] and max(out["turbo_ber"].values()) < 1e-2
            and out["turbo_sharded_eq_serial"] > 0.99
            and out["pipeline_eq_payload"] == 1.0
            and out["viterbi_ber"] < 1e-2 and out["fir_max_err"] < 1e-4):
        bad.append(f"the sharded demos: "
                   f"{ {k: v for k, v in out.items() if k != 'ldpc_decisions'} }")
    return bad


def examples_path(torch, report):
    """The examples phase: each ``examples/torch`` script's
    ``main(device="cuda")`` in this process at its default (full) size,
    the kernel counts set to 0 just before and read just after, its wall
    time, and :func:`check_example`'s checks (the NumPy-draw scripts are
    run on the host too, uncounted, to compare).  ``plot_constellations``
    draws on the host with matplotlib and launches nothing on the card;
    where matplotlib is not installed it is reported as not run.  One K1/K2 call
    (``wifi80211_bers``), one K3 call of the turbo decoder
    (``ldpc_turbo_links``) and one of the renormalising turbo stream
    (``sharded_decoding``), recorded as the scripts make them, are held
    to their plain versions on the card, bit for bit.  The process group
    the scripts' one-rank meshes start is destroyed at the end.
    Returns {kernel: {"examples": launches}}."""
    import importlib.util
    import tempfile

    from commpy_tpu_torch.kernels import bcjr as BK
    from commpy_tpu_torch.kernels import qc_bp as QK
    from commpy_tpu_torch.kernels import viterbi_acs as K
    from commpy_tpu_torch.ops import stream as ST
    from commpy_tpu_torch.ops import turbo as OT
    from commpy_tpu_torch.ops import viterbi as OV

    counters = {"acs_forward": K.acs_forward, "traceback": K.traceback,
                "qc_bp_resident": QK.qc_bp_resident,
                "qc_bp_streamed": QK.qc_bp_streamed,
                "bcjr_appdiff": BK.bcjr_appdiff}
    record = {"wifi80211_bers": (OV, ("acs_forward", "traceback")),
              "ldpc_turbo_links": (OT, ("bcjr_appdiff",)),
              "sharded_decoding": (ST, ("bcjr_appdiff",))}
    host_too = ("dvbt_outer_chain", "nr_ldpc_rate_matching",
                "design_qc_ldpc", "receiver_frontend")
    total = {k: 0 for k in counters}
    rows, calls = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        for name in EXAMPLES:
            if (name == "plot_constellations"
                    and importlib.util.find_spec("matplotlib") is None):
                rows[name] = {"not_run": "matplotlib is not installed"}
                print(f"examples/torch/{name}.py: not run, matplotlib is "
                      f"not installed on this machine", flush=True)
                continue
            mod = load_example(name)
            kw = {"out": tmp} if name == "plot_constellations" else {}
            box = {}

            def run(mod=mod, kw=kw, box=box):
                box["out"] = mod.main("cuda", **kw)
                torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            if name in record:
                calls[name] = record_calls(*record[name], run, keep=1)
            else:
                run()
            wall = time.perf_counter() - t0
            counts = {k: c.launches for k, c in counters.items()}
            out = box["out"]
            host = mod.main("cpu") if name in host_too else None
            bad = check_example(name, out, host)
            shown = {k: v for k, v in out.items() if k != "ldpc_decisions"}
            rows[name] = {"s": wall, "launches": counts, "out": shown,
                          "failed": bad}
            for k, v in counts.items():
                total[k] += v
            print(f"examples/torch/{name}.py: {wall:.2f} s; launches "
                  f"{counts}; {json.dumps(shown, default=str)[:1500]}",
                  flush=True)
            if bad:
                fail(f"examples/torch/{name}.py: {bad}")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    # the recorded calls against their plain versions
    held = {}
    (acs_a, _, (dec, best)), = calls["wifi80211_bers"]["acs_forward"]
    (tb_a, _, bits), = calls["wifi80211_bers"]["traceback"]
    t12 = {"acs_forward": Tally(), "traceback": Tally()}
    t12["acs_forward"].add(dec, K.acs_forward_plain(*acs_a)[0])
    t12["acs_forward"].add(best, K.acs_forward_plain(*acs_a)[1])
    t12["traceback"].add(bits, K.traceback_plain(*tb_a))
    held["wifi80211_bers"] = {k: {"compared": t.compared,
                                  "mismatches": t.mismatches}
                              for k, t in t12.items()}
    for name in ("ldpc_turbo_links", "sharded_decoding"):
        (a, kw, got), = calls[name]["bcjr_appdiff"]
        got = got if isinstance(got, tuple) else (got,)
        want = BK.bcjr_appdiff_plain(*a, **kw)
        want = want if isinstance(want, tuple) else (want,)
        tk = K3Tally()
        tk.add(got, want, True)
        held[name] = {"bcjr_appdiff": {
            "compared": tk.compared, "mismatches": tk.mismatches,
            "bit_diffs": tk.bit_diffs, "shape": list(a[0].shape),
            "renorm_every": kw.get("renorm_every", 0)}}
    print(f"examples: K1/K2 and K3 calls against their plain versions "
          f"{held}; launches over all scripts {total}; "
          f"{sum(r.get('s', 0) for r in rows.values()):.1f} s", flush=True)
    if any(t.mismatches for t in t12.values()) or any(
            v["bcjr_appdiff"]["mismatches"] or v["bcjr_appdiff"]["bit_diffs"]
            for k, v in held.items() if k != "wifi80211_bers"):
        fail(f"examples: a kernel call differs from its plain version: "
             f"{held}")
    if held["sharded_decoding"]["bcjr_appdiff"]["renorm_every"] != \
            ST.STREAM_RENORM_EVERY:
        fail("examples: the turbo stream's K3 call does not renormalise")
    if not all(total.values()):
        fail(f"examples: a kernel was not launched: {total}")
    report["examples"] = {"scripts": rows, "held_to_plain": held,
                          "launches": total}
    return {k: {"examples": v} for k, v in total.items()}


def tp_path(torch, report, codes, ldpc_link):
    """Path R: the tensor-parallel decoders, the sharded FIR and the
    pipeline at world size 1 over NCCL.

    ``ldpc_bp_decode_sharded`` on 802.11n (1944, 972) B=512 MSA-15 on
    Path A's LLRs (10 dB), equal to the dense one-device decode;
    ``qc_bp_decode_sharded`` on the DVB-S2-class (16200, 1/2) code, B=512,
    MSA flooding-15, equal to the plain flooding core (bits and LLRs);
    ``sharded_fir_filter`` on 2^22 complex64 samples with Path H's RRC
    taps, within 1e-5 relative of ``fir_filter(x, taps, 'full')[:n]``;
    ``pipeline_map`` of the four link stages of ``test_pipeline.py``
    composed into one stage, equal to their serial composition."""
    from commpy_tpu_torch.ops import fir as FIR
    from commpy_tpu_torch.ops import ldpc as L
    from commpy_tpu_torch.ops import qcldpc as Q
    from commpy_tpu_torch.ops.filters import rrcosfilter
    from commpy_tpu_torch.parallel import make_mesh, pipeline_map

    dev = torch.device("cuda")
    mesh = make_mesh(axis_name="dp")
    out = {}
    # 802.11n 1944 as a design file, decoded edge-sharded
    os.makedirs("build", exist_ok=True)
    design = os.path.join("build", "80211n_1944_r12.txt")
    Q.qc_export_design(codes["80211n-1944-1/2"][0], design)
    dense = L.get_ldpc_code_params(design)
    g = torch.Generator(device=dev)
    g.manual_seed(130)
    bits, noise = ldpc_link.draw(g, 512)
    llr = ldpc_link.receive(bits, noise, float(ldpc_link.noise_std_fn(10.0)))
    # the link's LLRs are in the QC codeword order, which is H's order

    def ldpc_run():
        return L.ldpc_bp_decode_sharded(llr, dense, "MSA", 15, mesh)

    d1, o1 = ldpc_run()
    d2, o2 = L.ldpc_bp_decode_device(llr, dense, "MSA", 15, backend="dense")
    errs = int((d1[:, :972] != bits).sum())
    raw = int((torch.signbit(llr)[:, :972].to(torch.int8) != bits).sum())
    step = host_step_s(torch, ldpc_run)
    out["ldpc_1944_b512_msa15"] = {
        "equal_to_dense": bool(torch.equal(d1, d2) and torch.equal(o1, o2)),
        "info_errors": errs, "channel_info_errors": raw, "step_s": step,
        "info_bits_per_s": 512 * 972 / step,
        "profile": profile_call(torch, ldpc_run, step,
                                "Path R ldpc_bp_decode_sharded 1944")}
    # DVB-S2-class, Z-sharded
    pd, make = codes["dvbs2-16200-1/2"]
    rng = np.random.RandomState(131)
    cw = make(512, rng)
    qllr = torch.as_tensor(bpsk_llr(cw, 2.0, 0.5, rng), device=dev)

    def qc_run():
        return Q.qc_bp_decode_sharded(qllr, pd, "MSA", 15, mesh)

    a = qc_run()
    b = Q.qc_bp_decode_device(qllr, pd, "MSA", 15, backend="torch")
    step = host_step_s(torch, qc_run, reps=2)
    out["qc_dvbs2_16200_b512_msa15"] = {
        "equal_to_plain_core": bool(torch.equal(a[0], b[0])
                                    and torch.equal(a[1], b[1])),
        "errors": int((a[0].cpu().numpy() != cw).sum()),
        "channel_errors": int((np.signbit(qllr.cpu().numpy()) != cw).sum()),
        "step_s": step, "info_bits_per_s": 512 * pd["k_bits"] / step,
        "profile": profile_call(torch, qc_run, step,
                                "Path R qc_bp_decode_sharded DVB-S2",
                                steps=1)}
    # the sharded FIR on 2^22 samples with Path H's taps
    _, taps = rrcosfilter(32, 0.35, 1.0, 4.0)
    taps = torch.as_tensor((taps / np.sqrt(np.sum(taps ** 2))).astype(
        np.float32), device=dev)
    xs = torch.as_tensor((rng.randn(1 << 22) + 1j * rng.randn(1 << 22))
                         .astype(np.complex64), device=dev)
    sp = make_mesh(axis_name="sp")

    def fir_run():
        return FIR.sharded_fir_filter(xs, taps, sp)

    y = fir_run()
    want = FIR.fir_filter(xs, taps, "full")[:1 << 22]
    rel = float((y - want).abs().max() / want.abs().max())
    step = host_step_s(torch, fir_run)
    out["fir_2p22_rrc"] = {"max_rel_err": rel, "step_s": step,
                           "msamples_per_s": (1 << 22) / step / 1e6}
    # the pipeline: four link stages composed into one (world size 1)
    stages = [lambda w: torch.stack([2.0 * w[1] - 1.0, w[1]]),
              lambda w: torch.stack([w[0] * 0.9, w[1]]),
              lambda w: torch.stack([2.0 * w[0] / 0.5, w[1]]),
              lambda w: torch.stack([(w[0] > 0).to(w.dtype), w[1]])]

    def chain(w):
        for f in stages:
            w = f(w)
        return w

    bits_w = torch.as_tensor(rng.randint(0, 2, (6, 4096)).astype(np.float32),
                             device=dev)
    wire = torch.stack([torch.zeros_like(bits_w), bits_w], 1)
    piped = pipeline_map([chain], wire, mesh)
    serial = torch.stack([chain(w) for w in wire])
    out["pipeline_1_stage"] = {"equal_to_serial": bool(torch.equal(piped,
                                                                    serial)),
                               "decisions_exact": bool(torch.equal(
                                   piped[:, 0], bits_w))}
    brief = {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
             for k, v in out.items()}
    print(f"Path R: {json.dumps(brief)}", flush=True)
    if not out["ldpc_1944_b512_msa15"]["equal_to_dense"]:
        fail("Path R: ldpc_bp_decode_sharded differs from the dense decode")
    if not errs < raw:
        fail(f"Path R: {errs} info errors after the sharded decode, {raw} "
             f"before")
    q = out["qc_dvbs2_16200_b512_msa15"]
    if not q["equal_to_plain_core"] or not q["errors"] < q["channel_errors"]:
        fail(f"Path R: qc_bp_decode_sharded {q}")
    if not rel <= 1e-5:
        fail(f"Path R: the sharded FIR is {rel} off fir_filter")
    if not all(out["pipeline_1_stage"].values()):
        fail(f"Path R: pipeline_map {out['pipeline_1_stage']}")
    report["path_r"] = out


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
        from commpy_tpu_torch.kernels import qc_bp as QK
        from commpy_tpu_torch.models import wifi80211n_ldpc_link
        from commpy_tpu_torch.ops import dvbs2 as D
        from commpy_tpu_torch.ops import nrldpc as N
        from commpy_tpu_torch.ops import qcldpc as Q
        from commpy_tpu_torch.kernels import bcjr as BK
        from commpy_tpu_torch.models import make_turbo_awgn_link
        from commpy_tpu_torch.ops.interleave import RandInterlv
        from commpy_tpu_torch.ops.turbo import (turbo_decode_device,
                                                turbo_encode_device)
    except ImportError as e:
        print(f"chip_smoke: the commpy_tpu_torch port is not importable "
              f"here ({e})", file=sys.stderr)
        return 2
    from scipy.special import erfc

    t_start = time.perf_counter()
    phase_s = {}

    def lap(name):
        """Seconds since the previous phase ended, kept under ``name``."""
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())
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
    regs = ptxas_report(paths)
    report["ptxas"] = regs
    for name in KERNEL_NAMES:
        if name not in regs:
            fail(f"no -Xptxas -v report of {name}")
        print(f"{name}: {regs_summary(regs[name])}", flush=True)

    lap("build")
    # ---- K6, the joint demapper, against its plain version; its time --
    k6_phase(torch, report)

    lap("k6")
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
        # opt-in) and past what shared memory holds (read from global)
        (Trellis(np.array([10]), np.array([[0o2335, 0o3661]])), "soft", 3,
         500, 60),
        (Trellis(np.array([10]), np.array([[0o2335, 0o3661]])), "hard", 3,
         2000, 100),
        # the traceback: tb_depth past T (every window ends at T - 1; a
        # lane's first walk spans the frame), tb_depth 3, T < 32
        (k7, "soft", 4, 1200, 1300),
        (k7, "soft", 3, 100, 3),
        (k7, "soft", 5, 20, 30),
        # the warp layout at S = 8, 16 and 32 (8, 4 and 2 frames a warp)
        # and n = 1, 3 and 8, the block layout at S = 128: B no multiple
        # of the frames a warp, T no multiple of 32
        (Trellis(np.array([3]), np.array([[0o15, 0o17]])), "soft", 13, 77,
         20),
        (Trellis(np.array([4]), np.array([[0o23, 0o35]])), "hard", 7, 90, 20),
        (Trellis(np.array([5]), np.array([[0o53, 0o75]])), "unquantized", 5,
         100, 25),
        (Trellis(np.array([7]), np.array([[0o247, 0o371]])), "soft", 5, 140,
         35),
        (Trellis(np.array([4]), np.array([[0o23]])), "hard", 9, 61, 20),
        (Trellis(np.array([2]), np.array([[5, 7, 7]])), "unquantized", 19,
         75, 15),
        (Trellis(np.array([6]), np.array([[0o133, 0o171, 0o165, 0o117, 0o127,
                                           0o155, 0o163, 0o145]])), "soft", 3,
         70, 30),
    ]
    for i, (tr, dt, B, L, tb) in enumerate(small):
        compare_case(torch, tallies, tr, dt, B, L, tb, seed=100 + i)
    # every step a tie (r = 0) and -0.0 received values, on both layouts
    ties = [(Trellis(np.array([1]), np.array([[3, 1]])), "soft", 7, 50, 5),
            (Trellis(np.array([2]), np.array([[5, 7]])), "unquantized", 37,
             211, 15),
            (k7, "soft", 3, 100, 30), (k7, "hard", 5, 100, 30),
            (Trellis(np.array([8]), np.array([[0o561, 0o753]])), "soft", 3,
             150, 40)]
    for i, (tr, dt, B, L, tb) in enumerate(ties):
        r = kernel_input(torch, tr, dt, B, L, 200 + i, dev)
        compare_case(torch, tallies, tr, dt, B, L, tb, 0,
                     r=torch.zeros_like(r))
        r.view(-1)[::3] = -0.0
        compare_case(torch, tallies, tr, dt, B, L, tb, 0, r=r)
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
    k2_parity(torch, tallies["traceback"])
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

    lap("viterbi_parity")
    # ---- the main path ------------------------------------------------
    k6w = K6Watch(torch)
    K.acs_forward.launches = 0
    K.traceback.launches = 0
    res = k6w.count("MCS-4", lambda: montecarlo_ber(
        link.link_step, [12.0], link.noise_std_fn, link.frame_bits, seed=1,
        frames_per_round=2048, max_rounds=3, err_min=10 ** 9,
        device="cuda"))
    main_launches = {"acs_forward": K.acs_forward.launches,
                     "traceback": K.traceback.launches,
                     "demap_joint": k6w.launches["MCS-4"]}
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

    lap("main_path_and_physics")
    # ---- QC-LDPC kernels against their plain versions ------------------
    t0 = time.perf_counter()
    codes = ldpc_codes()
    qc_tallies = {"qc_bp_resident": QCTally(), "qc_bp_streamed": QCTally()}
    k4_parity(torch, qc_tallies["qc_bp_resident"], codes)
    k5_parity(torch, qc_tallies["qc_bp_streamed"], codes)
    for name, tally in qc_tallies.items():
        print(f"{name}: {tally.mismatches} mismatches in {tally.cases} cases, "
              f"{tally.compared} decisions and as many posteriors; SPA "
              f"largest |diff|/(1+|plain|) {tally.spa_max_rel:.3e}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    lap("qc_parity")
    # ---- Path A: the 802.11n LDPC link ---------------------------------
    ldpc_link = wifi80211n_ldpc_link(1944, 16)
    QK.qc_bp_resident.launches = 0
    res_a = k6w.count("A", lambda: montecarlo_ber(
        ldpc_link.link_step, [10.0], ldpc_link.noise_std_fn,
        ldpc_link.frame_bits, seed=5, frames_per_round=512, max_rounds=3,
        err_min=10 ** 9, device="cuda"))
    launches_a = QK.qc_bp_resident.launches
    print(f"Path A 802.11n LDPC 1944 16-QAM F=512 at 10 dB: {res_a.rounds} "
          f"steps, BER {res_a.bers[0]:.3e}; qc_bp_resident launches "
          f"{launches_a}, demap_joint {k6w.launches['A']}", flush=True)
    if res_a.rounds != 3 or res_a.bits_sent[0] != 3 * 512 * 972:
        fail(f"Path A ran {res_a.rounds} rounds")
    if not np.isfinite(res_a.bers).all() or not res_a.bers[0] < 0.1:
        fail(f"Path A BER at 10 dB is {res_a.bers[0]}")
    if launches_a == 0:
        fail("Path A never launched qc_bp_resident")
    report["path_a"] = {"bit_errors": res_a.bit_errors.tolist(),
                        "bits_sent": res_a.bits_sent.tolist(),
                        "ber": res_a.bers.tolist(), "launches": launches_a,
                        "demap_joint_launches": k6w.launches["A"]}
    # physics through the kernels, on NumPy-made inputs
    rng = np.random.RandomState(11)
    p1944, make1944 = codes["80211n-1944-1/2"]
    cw = make1944(256, rng)
    dec, _ = Q.qc_bp_decode_device(bpsk_llr(cw, 2.5, 0.5, rng), p1944, "SPA",
                                   30)
    spa_ber = float((dec.cpu().numpy() != cw).mean())
    p648, make648 = codes["80211n-648-1/2"]
    cw = make648(256, rng)
    llr = bpsk_llr(cw, 2.75, 0.5, rng)
    err_flood = int((Q.qc_bp_decode_device(llr, p648, "MSA", 15)[0].cpu()
                     .numpy() != cw).sum())
    err_layer = int((Q.qc_bp_decode_device(llr, p648, "MSA", 8,
                                           schedule="layered")[0].cpu()
                     .numpy() != cw).sum())
    gen.manual_seed(6)
    e35 = int(ldpc_link.link_step(gen, 256,
                                  float(ldpc_link.noise_std_fn(35.0))))
    e5 = int(ldpc_link.link_step(gen, 256, float(ldpc_link.noise_std_fn(5.0))))
    print(f"802.11n 1944 BPSK 2.5 dB SPA-30 BER {spa_ber:.3e}; 648 at 2.75 dB "
          f"errors: flooding-15 {err_flood}, layered-8 {err_layer}; 16-QAM "
          f"link errors {e35} at 35 dB, {e5} at 5 dB", flush=True)
    if not spa_ber < 1e-3:
        fail("802.11n 1944 SPA-30 BER at 2.5 dB is not under 1e-3")
    if not err_layer <= err_flood:
        fail("layered-8 makes more errors than flooding-15")
    if not e35 == 0 < e5:
        fail("802.11n LDPC link fails errs(35 dB) == 0 < errs(5 dB)")
    report["physics"].update({
        "ldpc1944_bpsk_2p5db_spa30_ber": spa_ber,
        "ldpc648_2p75db_errors_flooding15": err_flood,
        "ldpc648_2p75db_errors_layered8": err_layer,
        "ldpc_link_errs_35db": e35, "ldpc_link_errs_5db": e5})

    lap("path_a")
    # ---- Path B: dvbs2_decode_device and NR BG1 --------------------------
    pd = codes["dvbs2-16200-1/2"][0]
    pn, make_nr = codes["nr-bg1-z208"]
    rng = np.random.RandomState(12)
    msg = rng.randint(0, 2, (512, pd["k_bits"])).astype(np.int8)
    cw_d = D.dvbs2_encode_device(msg, pd).cpu().numpy()
    cw_n = make_nr(512, rng)
    inputs = {"dvbs2": (cw_d, bpsk_llr(cw_d, 2.0, 0.5, rng)),
              "nr": (cw_n, bpsk_llr(cw_n, 2.0, pn["k_bits"] / pn["n_vnodes"],
                                    rng))}
    QK.qc_bp_streamed.launches = 0
    path_b = {}
    for io in ("f32", "bf16"):
        for name, (cw, llr) in inputs.items():
            if name == "dvbs2":
                def run(x):
                    return D.dvbs2_decode_device(x, pd, "MSA", 8, msg_io=io)
            else:
                def run(x):
                    return Q.qc_bp_decode_device(x, pn, "MSA", 8,
                                                 schedule="layered",
                                                 msg_io=io)
            clean = run((1.0 - 2.0 * cw).astype(np.float32) * 8)[0]
            noisy = run(llr)[0]
            errs = int((noisy.cpu().numpy() != cw).sum())
            raw = int((np.signbit(llr) != cw).sum())
            exact = bool((clean.cpu().numpy() == cw).all())
            path_b[f"{name}_{io}"] = {"noisy_errors": errs,
                                      "channel_errors": raw,
                                      "noiseless_exact": exact}
            if not exact:
                fail(f"Path B {name} {io}: noiseless input does not decode "
                     f"to itself")
            if not errs < raw:
                fail(f"Path B {name} {io}: {errs} errors after decoding, "
                     f"{raw} before")
    launches_b = QK.qc_bp_streamed.launches
    print(f"Path B B=512 layered-8 MSA at Eb/N0 2 dB: {path_b}; "
          f"qc_bp_streamed launches {launches_b}", flush=True)
    if launches_b == 0:
        fail("Path B never launched qc_bp_streamed")
    report["path_b"] = dict(path_b, launches=launches_b)

    lap("path_b")
    # ---- K3 against its plain version ----------------------------------
    t0 = time.perf_counter()
    k3_tally = K3Tally()
    trellises = rsc_trellises()
    k3_parity(torch, k3_tally, trellises)
    print(f"bcjr_appdiff: {k3_tally.mismatches} mismatches in "
          f"{k3_tally.cases} cases, {k3_tally.compared} values; "
          f"{k3_tally.bit_diffs} differ in any bit (largest "
          f"|diff|/(1+|plain|) {k3_tally.max_rel_err:.3e}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    k3_renorm = K3Tally()
    k3_renorm_parity(torch, k3_renorm, trellises)
    print(f"bcjr_appdiff renorm_every 1, 2 and 4: {k3_renorm.mismatches} "
          f"mismatches, {k3_renorm.bit_diffs} values differing in any bit, "
          f"in {k3_renorm.cases} cases, {k3_renorm.compared} values; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if k3_renorm.mismatches or k3_renorm.bit_diffs or not k3_renorm.cases:
        fail("bcjr_appdiff with renorm_every differs from its plain version")
    report["k3_renorm_parity"] = {
        "cases": k3_renorm.cases, "compared": k3_renorm.compared,
        "mismatches": k3_renorm.mismatches,
        "bit_diffs": k3_renorm.bit_diffs}

    lap("k3_parity")
    # ---- Path C: the rate-1/3 turbo link -------------------------------
    trt = trellises[1][1]
    p6144 = RandInterlv(6144, 0).p_array
    turbo = make_turbo_awgn_link(trellis=trt, frame_bits=6144,
                                 p_array=p6144, n_iterations=8,
                                 window=(128, 0), window_init="nii")
    # real noise at rate 1/3: the link's SNR is Eb/N0 + 3.01 dB
    snr_c = 1.0 + 10 * np.log10(2)
    BK.bcjr_appdiff.launches = 0
    res_c = montecarlo_ber(turbo.link_step, [snr_c], turbo.noise_std_fn,
                           turbo.frame_bits, seed=8, frames_per_round=256,
                           max_rounds=3, err_min=10 ** 9, device="cuda")
    launches_c = BK.bcjr_appdiff.launches
    print(f"Path C turbo L=6144 NII (128, 0) F=256 at Eb/N0 1.0 dB: "
          f"{res_c.rounds} steps, BER {res_c.bers[0]:.3e} "
          f"({res_c.bit_errors[0]:.0f} errors); bcjr_appdiff launches "
          f"{launches_c}", flush=True)
    if res_c.rounds != 3 or res_c.bits_sent[0] != 3 * 256 * 6144:
        fail(f"Path C ran {res_c.rounds} rounds")
    if launches_c != 16 * 3:
        fail(f"Path C launched bcjr_appdiff {launches_c} times in 3 steps, "
             f"not 16 a step")
    if not np.isfinite(res_c.bers).all() or not res_c.bers[0] < 1e-2:
        fail(f"Path C BER at Eb/N0 1.0 dB is {res_c.bers[0]}")
    report["path_c"] = {"bit_errors": res_c.bit_errors.tolist(),
                        "bits_sent": res_c.bits_sent.tolist(),
                        "ber": res_c.bers.tolist(), "launches": launches_c}
    # physics through K3, on NumPy-made inputs
    gen.manual_seed(9)
    e35 = int(turbo.link_step(gen, 64, float(turbo.noise_std_fn(35.0))))
    em5 = int(turbo.link_step(gen, 64, float(turbo.noise_std_fn(-5.0))))
    rng = np.random.RandomState(14)
    msg_t = torch.as_tensor(rng.randint(0, 2, (256, 6144)).astype(np.int8),
                            device=dev)
    tx = 2.0 * torch.stack(turbo_encode_device(msg_t, trt, trt, p6144)).to(
        torch.float32) - 1.0  # [3, B, L]
    noise = torch.as_tensor(rng.randn(3, 256, 6144).astype(np.float32),
                            device=dev)

    def turbo_ber(ebn0_db, msg, x, z, p_array, **kw):
        nv = np.float32(1 / (2 * (1 / 3) * 10 ** (ebn0_db / 10)))
        y = x + z * float(np.sqrt(nv))
        d = turbo_decode_device(y[0], y[1], y[2], trt, nv, 8, p_array, **kw)
        return float((d != msg).float().mean())

    configs = {"whole_frame": {}, "window_256_32": {"window": (256, 32)},
               "nii_128": {"window": (128, 0), "window_init": "nii"}}
    turbo_phys = {}
    for name, kw in configs.items():
        turbo_phys[name] = {
            db: turbo_ber(db, msg_t, tx, noise, p6144, **kw)
            for db in (2.0, 1.5, -1.0)}
    turbo_phys["nii_128_bf16"] = {db: turbo_ber(
        db, msg_t, tx, noise, p6144, kernel_io="bf16", **configs["nii_128"])
        for db in (2.0, 1.5)}
    p512 = RandInterlv(512, 0).p_array
    msg_s = torch.as_tensor(rng.randint(0, 2, (64, 512)).astype(np.int8),
                            device=dev)
    tx_s = 2.0 * torch.stack(turbo_encode_device(msg_s, trt, trt, p512)).to(
        torch.float32) - 1.0
    noise_s = torch.as_tensor(rng.randn(3, 64, 512).astype(np.float32),
                              device=dev)
    maxlog = {es: turbo_ber(0.0, msg_s, tx_s, noise_s, p512,
                            algorithm="max-log", ext_scale=es)
              for es in (1.0, 0.7)}
    print(f"turbo link errors {e35} at 35 dB, {em5} at -5 dB; L=6144 B=256 "
          f"8 it BER by Eb/N0 (dB): {turbo_phys}; L=512 B=64 max-log at 0 dB "
          f"BER by ext_scale {maxlog}", flush=True)
    if not e35 == 0 < em5:
        fail("turbo link fails errs(35 dB) == 0 < errs(-5 dB)")
    # this 4-state code reaches BER 1e-4 near Eb/N0 1.5 dB at L=6144 (the
    # JAX package decodes the same frames to the same bits), so the
    # waterfall check is made at 2.0 dB and 1.5 dB is reported beside it
    for name, bers in turbo_phys.items():
        if not bers[2.0] < 1e-4:
            fail(f"turbo {name} BER at Eb/N0 2.0 dB is {bers[2.0]}")
        if -1.0 in bers and not bers[-1.0] > 1e-2:
            fail(f"turbo {name} BER at Eb/N0 -1 dB is {bers[-1.0]}")
    if not maxlog[0.7] < maxlog[1.0]:
        fail("max-log with ext_scale 0.7 does not beat 1.0 at 0 dB")
    report["physics"].update({
        "turbo_link_errs_35db": e35, "turbo_link_errs_m5db": em5,
        "turbo_l6144_ber": {k: {str(db): b for db, b in v.items()}
                            for k, v in turbo_phys.items()},
        "turbo_l512_maxlog_0db_ber": {str(k): v for k, v in maxlog.items()}})

    lap("path_c_and_physics")
    # every kernel's launches by path; a record's launches are their sum
    path_launches = {
        "acs_forward": {"MCS-4": main_launches["acs_forward"]},
        "traceback": {"MCS-4": main_launches["traceback"]},
        "qc_bp_resident": {"A": launches_a},
        "qc_bp_streamed": {"B": launches_b},
        "bcjr_appdiff": {"C": launches_c},
        "demap_joint": k6w.launches}

    def add_launches(counts):
        for name, paths in counts.items():
            path_launches[name].update(paths)

    # ---- Paths D-G: MIMO detection and OFDM -----------------------------
    add_launches(k6w.count("D-G", lambda: mimo_ofdm_paths(torch, report,
                                                          k7)))
    auto_past_the_limits(torch, report)

    lap("paths_d_to_g")
    # ---- Paths H-L: single-carrier DSP and the algebraic codes -----------
    add_launches(k6w.count("H-L", lambda: dsp_code_paths(torch, report,
                                                         k7)))

    lap("paths_h_to_l")
    # ---- Paths M-O: polar, the IDD link, the CommPy-compatible API ------
    k6w.count("M", lambda: polar_path(torch, report))
    lap("path_m")
    add_launches(k6w.count("N", lambda: idd_path(torch, report), False))
    lap("path_n")
    add_launches(k6w.count("O", lambda: api_path(torch, report)))
    lap("path_o")
    # ---- Paths P-R: data, sequence and tensor parallelism (NCCL) ---------
    add_launches(k6w.count("P", lambda: dp_path(torch, report, link, res,
                                                uncoded_2db, k7)))
    lap("path_p")
    add_launches(k6w.count("Q", lambda: stream_path(torch, report, k7),
                           False))
    lap("path_q")
    k6w.count("R", lambda: tp_path(torch, report, codes, ldpc_link), False)
    torch.distributed.destroy_process_group()
    lap("path_r")
    # ---- the examples: every examples/torch script at its own size -------
    add_launches(k6w.count("examples", lambda: examples_path(torch, report),
                           False))
    lap("examples")
    # ---- timing -------------------------------------------------------
    timings = {}
    tb_inputs = {}
    for shape, r in (("mcs4", r_mcs4), ("bench", r_bench)):
        B, T, n = r.shape
        dec, best = K.acs_forward(r, C7)
        tb_inputs[shape] = (dec, best)
        # the back-steps a merge-aware walk takes on these decisions, and
        # its bits once more
        bits_m, steps_m = K.traceback_merge_plain(dec, best, 64, 30)
        if not torch.equal(bits_m, K.traceback(dec, best, 64, 30)):
            fail(f"K2 {shape}: the kernel differs from traceback_merge_plain")
        timings[shape] = {
            "B": B, "T": T,
            "acs_ms": cuda_ms(torch, lambda: K.acs_forward(r, C7), 10),
            "acs_device_ms": device_ms(
                torch, lambda: K.acs_forward(r, C7), 10, "acs_"),
            "acs_plan": K.acs_plan(64, n, B),
            "acs_plain_ms": cuda_ms(
                torch, lambda: K.acs_forward_plain(r, C7), 2),
            "tb_ms": cuda_ms(torch, lambda: K.traceback(dec, best, 64, 30),
                             20),
            "tb_device_ms": device_ms(
                torch, lambda: K.traceback(dec, best, 64, 30), 20,
                "traceback"),
            "tb_plain_ms": cuda_ms(
                torch, lambda: K.traceback_plain(dec, best, 64, 30), 3),
            "tb_plan": K.traceback_plan(64, T, 30, B),
            "tb_steps_per_frame": k2_steps(T, 64, 30, skip=True),
            "tb_full_steps_per_frame": k2_steps(T, 64, 30),
            "tb_merge_steps_per_frame": int(steps_m.sum()) / B,
            "tb_merge_lane_steps_max": int(steps_m.max()),
            "acs_bound": k1_bound(B, T, n, 64),
            # the function's least work on these decisions: a merge-aware
            # walk's back-steps; beside it K2's own and every window's full
            # walk
            "tb_bound": k2_bound(B, T, 64, int(steps_m.sum())),
            "tb_own_bound": k2_bound(B, T, 64,
                                     B * k2_steps(T, 64, 30, skip=True)),
            "tb_full_bound": k2_bound(B, T, 64, B * k2_steps(T, 64, 30)),
        }
    for shape, t in timings.items():
        print(f"K1 {shape} B={t['B']} T={t['T']}: {t['acs_ms']:.4f} ms a "
              f"call, {ms_str(t['acs_device_ms'])} ms of device time (plain "
              f"{t['acs_plain_ms']:.1f} ms), bound "
              f"{bound_ms(*t['acs_bound'])[0]:.4f} ms; plan {t['acs_plan']}",
              flush=True)
        print(f"K2 {shape} B={t['B']} T={t['T']}: {t['tb_ms']:.4f} ms a call, "
              f"{ms_str(t['tb_device_ms'])} ms of device time (plain "
              f"{t['tb_plain_ms']:.2f} ms); back-steps a frame: K2 "
              f"{t['tb_steps_per_frame']}, full walks "
              f"{t['tb_full_steps_per_frame']}, merge-aware "
              f"{t['tb_merge_steps_per_frame']:.1f} (a lane at most "
              f"{t['tb_merge_lane_steps_max']}); bound "
              f"{bound_ms(*t['tb_bound'], INT32_OPS_PER_S)[0]:.4f} ms by "
              f"{bound_ms(*t['tb_bound'], INT32_OPS_PER_S)[1]} (merge-aware; "
              f"K2's own back-steps "
              f"{bound_ms(*t['tb_own_bound'], INT32_OPS_PER_S)[0]:.4f}, "
              f"full walks "
              f"{bound_ms(*t['tb_full_bound'], INT32_OPS_PER_S)[0]:.4f}); "
              f"plan {t['tb_plan']}", flush=True)
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
    # K4 and K5 at the JAX bench shapes (benchmarks/bench_all.py): random
    # LLRs, on which no frame converges
    rng = np.random.RandomState(13)
    x4 = torch.as_tensor(np.clip(rng.randn(512, 1944) * 2, -500, 500).astype(
        np.float32), device=dev)
    x4l = torch.as_tensor(np.clip(rng.randn(512, 1944) * 2 + 1, -500,
                                  500).astype(np.float32), device=dev)
    x5 = torch.as_tensor(np.clip(rng.randn(512, 16200) * 2, -500, 500)
                         .astype(np.float32), device=dev)
    m4 = (p1944["Z"], p1944["Nb"], Q.qc_rows(p1944))
    m5 = (pd["Z"], pd["Nb"], Q.qc_rows(pd))
    pm5 = Q._pos_masks(pd)
    qc_runs = {
        "k4_flooding15": (QK.qc_bp_resident, QK.qc_bp_resident_plain, x4,
                          p1944, dict(algorithm="MSA", n_iters=15, meta=m4)),
        "k4_layered8": (QK.qc_bp_resident, QK.qc_bp_resident_plain, x4l,
                        p1944, dict(algorithm="MSA", n_iters=8, meta=m4,
                                    schedule="layered")),
        "k5_f32": (QK.qc_bp_streamed, QK.qc_bp_streamed_plain, x5, pd,
                   dict(algorithm="MSA", n_iters=8, meta=m5, pos_masks=pm5)),
        "k5_bf16": (QK.qc_bp_streamed, QK.qc_bp_streamed_plain, x5, pd,
                    dict(algorithm="MSA", n_iters=8, meta=m5, pos_masks=pm5,
                         msg_io="bf16")),
    }
    for key, (kern, plain, x, prm, kw) in qc_runs.items():
        dec, _ = kern(x, **kw)
        iters = sweeps_needed(torch, prm, dec, kw["n_iters"])
        edges = int(np.sum(np.asarray(prm["block_j"]) >= 0)) * prm["Z"]
        msg_bytes = 2 if kw.get("msg_io") == "bf16" else 4
        name = ("qc_bp_streamed_kernel" if kern is QK.qc_bp_streamed
                else "qc_bp_resident_kernel")
        timings[key] = {
            "B": x.shape[0], "n": x.shape[1], "n_iters": kw["n_iters"],
            "frames_converged": int((iters < kw["n_iters"]).sum()),
            "ms": cuda_ms(torch, lambda: kern(x, **kw), 10),
            "device_ms": device_ms(torch, lambda: kern(x, **kw), 5, name),
            "plain_ms": cuda_ms(torch, lambda: plain(x, **kw), 1, warmup=0),
            "bound": qc_bound(x.shape[0], x.shape[1], edges, iters,
                              msg_bytes if kern is QK.qc_bp_streamed else 0),
        }
        b = timings[key]
        print(f"{key}: {b['ms']:.3f} ms a call, {ms_str(b['device_ms'], 3)} ms of "
              f"device time (plain {b['plain_ms']:.1f} ms), "
              f"bound {bound_ms(*b['bound'][:2])[0]:.4f} ms, message store "
              f"{b['bound'][2] / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
        if kern is QK.qc_bp_resident:
            g4 = QK._graph(kw["meta"])
            b["plan"] = QK.resident_plan(g4["Z"], g4["Nb"], g4["Mb"],
                                         g4["E"], g4["kmax"],
                                         kw.get("schedule", "flooding"))
            # where K4's time goes: a launch that stops after 0, 1 and 2
            # sweeps, beside the bench's
            b["sweeps_device_ms"] = {k: device_ms(
                torch, lambda k=k, kw=kw: kern(x, **dict(kw, n_iters=k)), 5,
                "qc_bp_resident_kernel") for k in (0, 1, 2)}
            b["sweeps_device_ms"][kw["n_iters"]] = b["device_ms"]
            print(f"{key} plan {b['plan']}; device ms by sweeps "
                  f"{b['sweeps_device_ms']}", flush=True)
    # K5's frames in flight: 1, 2 and 3 frames a SM (where shared memory
    # holds them) beside the plan's, each held to the plan's bits
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for key in ("k5_f32", "k5_bf16"):
        io = "bf16" if key == "k5_bf16" else "f32"
        g5 = QK._graph(m5, pm5)
        plan = QK.streamed_plan(g5["Z"], g5["Nb"], g5["kmax"], g5["E"], 512,
                                io, sms)
        trade = {"plan_frames_per_sm": plan["frames_per_sm"],
                 "plan_store_mb": plan["store_bytes"] / 1e6}
        for f in (1, 2, 3):
            if f * (plan["smem_bytes"] + QK.SMEM_PER_BLOCK) > QK.SM_SMEM:
                trade[f"{f}_per_sm"] = (f"does not fit: {f} blocks of "
                                        f"{plan['smem_bytes']} bytes")
                continue
            trade[f"{f}_per_sm"] = k5_at_grid(torch, x5, m5, pm5, io,
                                              min(512, f * sms))
        timings[key]["frames_per_sm_trade"] = trade
        # where K5's time goes: a launch that stops after 0, 1 (no message
        # read) and 2 sweeps, beside the 8 of the bench
        timings[key]["sweeps_device_ms"] = {k: device_ms(
            torch, lambda k=k, io=io: QK.qc_bp_streamed(
                x5, "MSA", k, m5, pos_masks=pm5, msg_io=io), 3,
            "qc_bp_streamed_kernel") for k in (0, 1, 2)}
        timings[key]["sweeps_device_ms"][8] = timings[key]["device_ms"]
        print(f"{key} device ms by sweeps: "
              f"{timings[key]['sweeps_device_ms']}; frames per SM: "
              + ", ".join(f"{k} {ms_str(v['device_ms'], 3)} ms (store "
                          f"{v['store_mb']:.1f} MB)" if isinstance(v, dict)
                          else f"{k} {v}" for k, v in trade.items()),
              flush=True)
    # NR BG1 at Z=384 (rows of up to 24 blocks, one 175 KB block an SM),
    # random LLRs, 8 sweeps: held to the plain version, timed, and the
    # plan's grid beside the smaller one whose float32 stores would fit
    # 40 MB of the 50 MB L2
    p384 = N.nr_code_params(1, 384)
    m384 = (p384["Z"], p384["Nb"], Q.qc_rows(p384))
    x384 = torch.as_tensor(np.clip(rng.randn(512, p384["Nb"] * p384["Z"]) * 2,
                                   -500, 500).astype(np.float32), device=dev)
    g384 = QK._graph(m384)
    nr384 = {}
    for io in ("f32", "bf16"):
        qc_compare(torch, qc_tallies["qc_bp_streamed"], QK.qc_bp_streamed,
                   QK.qc_bp_streamed_plain, x384, True, False,
                   algorithm="MSA", n_iters=8, meta=m384, msg_io=io)
        plan = QK.streamed_plan(g384["Z"], g384["Nb"], g384["kmax"],
                                g384["E"], 512, io, sms)
        in_l2 = 40 * 2 ** 20 // (plan["store_bytes"] // plan["grid"])
        nr384[io] = {
            "ms": cuda_ms(torch, lambda io=io: QK.qc_bp_streamed(
                x384, "MSA", 8, m384, msg_io=io), 5),
            "plan": k5_at_grid(torch, x384, m384, (), io, plan["grid"]),
            "in_40mb_of_l2": k5_at_grid(torch, x384, m384, (), io,
                                        min(plan["grid"], in_l2))}
        print(f"K5 NR BG1 Z=384 B=512 {io} layered-8: {nr384[io]['ms']:.3f} "
              f"ms a call; device time {ms_str(nr384[io]['plan']['device_ms'], 3)} "
              f"ms at the plan's {plan['grid']} blocks, "
              f"{ms_str(nr384[io]['in_40mb_of_l2']['device_ms'], 3)} ms at "
              f"{nr384[io]['in_40mb_of_l2']['grid']}", flush=True)
    timings["k5_nr_bg1_z384"] = nr384
    # Path B end to end: the noisy decodes of the Path B phase, timed with
    # CUDA events; K5 alone on the same input, its sweeps and its bound
    path_b_t = {}
    for io in ("f32", "bf16"):
        for name, (cw, llr) in inputs.items():
            prm = pd if name == "dvbs2" else pn
            x = torch.as_tensor(llr, device=dev)
            if name == "dvbs2":
                def run(x=x, io=io):
                    return D.dvbs2_decode_device(x, pd, "MSA", 8, msg_io=io)
                q, k = pd["dvbs2"]["q"], pd["k_bits"]
                x_qc = torch.cat([x[:, :k], D._parity_to_qc(x[:, k:], q,
                                                            pd["Z"])], 1)
            else:
                def run(x=x, io=io):
                    return Q.qc_bp_decode_device(x, pn, "MSA", 8,
                                                 schedule="layered",
                                                 msg_io=io)
                x_qc = x
            x_qc = torch.clamp(x_qc, -500, 500).contiguous()
            meta = (prm["Z"], prm["Nb"], Q.qc_rows(prm))
            pmk = Q._pos_masks(prm)
            ms = cuda_ms(torch, run, 5)
            kern_ms = device_ms(torch, lambda: QK.qc_bp_streamed(
                x_qc, "MSA", 8, meta, pos_masks=pmk, msg_io=io), 5,
                "qc_bp_streamed_kernel")
            sweeps = sweeps_run(torch, prm, x_qc, 8, io)
            edges = int(np.sum(np.asarray(prm["block_j"]) >= 0)) * prm["Z"]
            bnd = qc_bound(512, x.shape[1], edges, sweeps,
                           2 if io == "bf16" else 4)
            path_b_t[f"{name}_{io}"] = {
                "decode_ms": ms, "info_bits_per_s": 512 * prm["k_bits"]
                / (ms * 1e-3), "k5_device_ms": kern_ms,
                "k5_bound_ms": bound_ms(*bnd[:2])[0],
                "sweeps_total": int(sweeps.sum()),
                "sweeps_mean": float(sweeps.mean()),
                "frames_converged": int((sweeps < 8).sum())}
            t = path_b_t[f"{name}_{io}"]
            print(f"Path B {name} {io} B=512 layered-8 at Eb/N0 2 dB: decode "
                  f"{ms:.3f} ms, {t['info_bits_per_s']:.4g} info bits/s; K5 "
                  f"{ms_str(kern_ms, 3)} ms over {t['sweeps_total']} sweeps (mean "
                  f"{t['sweeps_mean']:.2f}), bound {t['k5_bound_ms']:.4f} ms",
                  flush=True)
    report["path_b_timing"] = path_b_t
    ns_a = float(ldpc_link.noise_std_fn(10.0))
    gen.manual_seed(7)
    ldpc_link.link_step(gen, 512, ns_a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        ldpc_link.link_step(gen, 512, ns_a)
    torch.cuda.synchronize()
    step_a = (time.perf_counter() - t0) / reps
    ldpc_bps = 512 * 972 / step_a
    report["path_a_link_profile"] = profile_link_step(
        torch, ldpc_link, gen, ns_a, step_a, frames=512,
        label="802.11n LDPC 1944 16-QAM")
    report["80211n_ldpc_link_step_s"] = step_a
    report["80211n_ldpc_link_info_bits_per_s"] = ldpc_bps
    # K3 at the three bench shapes, as the turbo loop calls it (combined
    # w-streams, posterior out, log-MAP, f32)
    for key, (T, R, variant) in K3_BENCH.items():
        syn, pan, li, vkw = k3_inputs(torch, 4, T, R, variant, 5000, dev,
                                      halo=32)
        kw = dict(vkw, combined=True, posterior=True)
        timings[f"k3_{key}"] = {
            "T": T, "R": R, "variant": variant,
            "ms": cuda_ms(torch, lambda: BK.bcjr_appdiff(
                syn, pan, li, trt, **kw), 10),
            "device_ms": device_ms(torch, lambda: BK.bcjr_appdiff(
                syn, pan, li, trt, **kw), 5, "bcjr_kernel"),
            "plain_ms": cuda_ms(torch, lambda: BK.bcjr_appdiff_plain(
                syn, pan, li, trt, **kw), 1, warmup=0),
            "bound": k3_bound(T, R, 4, "exact", variant),
            "plan_hist": BK.bcjr_plan(T, 4, R, sms)["hist"],
        }
        t = timings[f"k3_{key}"]
        # each history placement, where shared memory holds it
        for hist in ("shared", "global"):
            try:
                BK.bcjr_plan(T, 4, R, sms, hist)
            except ValueError as e:
                t[f"{hist}_device_ms"] = f"does not fit: {e}"
                continue
            t[f"{hist}_device_ms"] = device_ms(torch, lambda: k3_call(
                torch, syn, pan, li, trt, hist, **kw), 5, "bcjr_kernel")
        if key == "nii":  # the renormalised variants at the same shape
            periods = [1, 2, 4]
            t["renorm"] = {}
            for N in periods:
                rkw = dict(kw, renorm_every=N)
                r = t["renorm"][N] = {
                    "device_ms": device_ms(torch, lambda: BK.bcjr_appdiff(
                        syn, pan, li, trt, **rkw), 5, "bcjr_kernel"),
                    "plain_ms": cuda_ms(torch, lambda: BK.bcjr_appdiff_plain(
                        syn, pan, li, trt, **rkw), 1, warmup=0),
                    "bound": k3_bound(T, R, 4, "exact", variant,
                                      renorm_every=N)}
                r["bound_ms"], r["bound_by"] = k3_bound_ms(*r["bound"][:3])
            # CUDA-event times in turns: default, each period, each period
            # again in reverse, default
            turns = [0] + periods + periods[::-1] + [0]
            times = [cuda_ms(torch, lambda N=N: BK.bcjr_appdiff(
                syn, pan, li, trt, **dict(kw, renorm_every=N)), 10)
                for N in turns]
            t["turns"] = list(zip(turns, times))
            for N in periods:
                r = t["renorm"][N]
                r["ms"] = float(np.mean([m for n, m in t["turns"]
                                         if n == N]))
                print(f"k3_nii renorm_every={N}: {r['ms']:.4f} ms a call, "
                      f"{ms_str(r['device_ms'])} ms of device time (plain "
                      f"{r['plain_ms']:.1f} ms), bound {r['bound_ms']:.4f} "
                      f"ms by {r['bound_by']}; in turns {t['turns']}",
                      flush=True)
        b_ms, b_by = k3_bound_ms(*t["bound"][:3])
        print(f"k3_{key} T={T} R={R}: {t['ms']:.4f} ms a call, "
              f"{ms_str(t['device_ms'])} ms of device time (plain "
              f"{t['plain_ms']:.1f} ms; history in {t['plan_hist']} memory; "
              f"device time with it shared {t['shared_device_ms']}, global "
              f"{t['global_device_ms']}), bound "
              f"{b_ms:.4f} ms by {b_by}, history "
              f"{t['bound'][3] / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    # the turbo decoder at the JAX bench's configurations
    # (benchmarks/bench_all.py:135-177): randn frames, nv 0.5, 8 iterations
    rng = np.random.RandomState(15)
    x256 = torch.as_tensor(rng.randn(4096, 256).astype(np.float32),
                           device=dev)
    x6144 = torch.as_tensor(rng.randn(256, 6144).astype(np.float32),
                            device=dev)
    p256 = RandInterlv(256, 0).p_array
    decoders = {
        "whole_frame_l256_b4096": (x256, p256, {}),
        "window_256_32_l6144_b256": (x6144, p6144, {"window": (256, 32)}),
        "nii_128_l6144_b256_f32": (x6144, p6144, configs["nii_128"]),
        "nii_128_l6144_b256_bf16": (x6144, p6144, dict(configs["nii_128"],
                                                       kernel_io="bf16")),
    }
    turbo_rates = {}
    for key, (x, p_arr, kw) in decoders.items():
        ms = cuda_ms(torch, lambda: turbo_decode_device(
            x, x, x, trt, 0.5, 8, p_arr, **kw), 3)
        turbo_rates[key] = x.numel() / (ms * 1e-3)
        print(f"turbo decoder {key}: {ms:.3f} ms, "
              f"{turbo_rates[key]:.4g} info bits/s", flush=True)
    ns_c = float(turbo.noise_std_fn(snr_c))
    gen.manual_seed(10)
    turbo.link_step(gen, 256, ns_c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        turbo.link_step(gen, 256, ns_c)
    torch.cuda.synchronize()
    step_c = (time.perf_counter() - t0) / 3
    turbo_bps = 256 * 6144 / step_c
    report["path_c_link_profile"] = profile_link_step(
        torch, turbo, gen, ns_c, step_c, frames=256,
        label="turbo L=6144 NII (128, 0)")
    report["turbo_link_step_s"] = step_c
    report["turbo_link_info_bits_per_s"] = turbo_bps
    report["turbo_decoder_info_bits_per_s"] = turbo_rates
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
        rate = INT32_OPS_PER_S if key == "tb" else F32_INSTR_PER_S
        # K2's bound is the function's least work on this run's decisions:
        # the bytes, or a merge-aware walk's back-steps; own_steps_bound_ms
        # counts K2's own back-steps (the full walks less the log2(S) - 1
        # it skips), full_walk_bound_ms every window's whole walk
        b_ms, b_by = bound_ms(*m4[f"{key}_bound"], rate)
        bb_ms, _ = bound_ms(*bn[f"{key}_bound"], rate)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces,
            "launches": sum(path_launches[name].values()),
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
        kernels[-1].update({
            "path_launches": path_launches[name],
            "redesigned": True, "device_ms": m4[f"{key}_device_ms"],
            "bench_device_ms": bn[f"{key}_device_ms"], "ms_note": MS_NOTE,
            "plan": m4[f"{key}_plan"]})
        if key == "tb":
            kernels[-1].update({
                "full_walk_bound_ms": bound_ms(*m4["tb_full_bound"],
                                               rate)[0],
                "bench_full_walk_bound_ms": bound_ms(*bn["tb_full_bound"],
                                                     rate)[0],
                "own_steps_bound_ms": bound_ms(*m4["tb_own_bound"],
                                               rate)[0],
                "bench_own_steps_bound_ms": bound_ms(*bn["tb_own_bound"],
                                                     rate)[0],
                "steps_per_frame": m4["tb_steps_per_frame"],
                "bench_steps_per_frame": bn["tb_steps_per_frame"],
                "full_steps_per_frame": m4["tb_full_steps_per_frame"],
                "merge_steps_per_frame": m4["tb_merge_steps_per_frame"],
                "bench_merge_steps_per_frame":
                    bn["tb_merge_steps_per_frame"]})
    for name, key, replaces, shape in (
            ("qc_bp_resident", "k4_flooding15",
             "commpy_tpu/kernels/qc_bp.py:290",
             "802.11n (1944, 972) B=512 MSA flooding-15"),
            ("qc_bp_streamed", "k5_f32", "commpy_tpu/kernels/qc_bp.py:565",
             "DVB-S2-class (16200, 7200) B=512 MSA layered-8 f32 store")):
        t = timings[key]
        other = timings["k4_layered8" if key == "k4_flooding15"
                        else "k5_bf16"]
        b_ms, b_by = bound_ms(*t["bound"][:2])
        store = (t["bound"][2] / HBM_BYTES_PER_S * 1e3
                 if name == "qc_bp_streamed" else None)
        kernels.append({
            "name": name, "route": "cuda", "source": QC_SOURCE,
            "replaces": replaces,
            "launches": sum(path_launches[name].values()),
            "path_launches": path_launches[name],
            "mismatches": qc_tallies[name].mismatches,
            "compared": qc_tallies[name].compared,
            "max_abs_err": qc_tallies[name].max_abs_err,
            "spa_max_rel_err": qc_tallies[name].spa_max_rel,
            "ms": t["ms"], "kernel_ms": t["ms"], "device_ms": t["device_ms"],
            "ms_note": MS_NOTE, "plain_ms": t["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "store_bound_ms": store,
            "bound_note": "bound_ms counts LLRs in and outputs out; the "
            + ("c2v messages stay in shared memory" if store is None else
               "message store is scratch of this design (the frames in "
               "flight's), read and written once a sweep: store_bound_ms is "
               "its time were all of it to go to device memory"),
            "shape": shape, "frames_converged": t["frames_converged"],
            "second_ms": other["ms"], "second_device_ms": other["device_ms"],
            "second_plain_ms": other["plain_ms"],
            "second_bound_ms": bound_ms(*other["bound"][:2])[0],
            "second_shape": "layered-8" if key == "k4_flooding15"
            else "bf16 store",
        })
        if name == "qc_bp_resident":
            kernels[-1].update({
                "redesigned": True, "plan": t["plan"],
                "sweeps_device_ms": t["sweeps_device_ms"],
                "second_plan": other["plan"],
                "second_sweeps_device_ms": other["sweeps_device_ms"]})
        if name == "qc_bp_streamed":
            kernels[-1].update({
                "redesigned": True,
                "frames_per_sm_trade": t["frames_per_sm_trade"],
                "second_frames_per_sm_trade": other["frames_per_sm_trade"],
                "nr_bg1_z384": timings["k5_nr_bg1_z384"],
                "path_b": path_b_t})
    t = timings["k3_nii"]
    b_ms, b_by = k3_bound_ms(*t["bound"][:3])
    extra = {}
    for key in ("whole_frame", "warmup_window"):
        o = timings[f"k3_{key}"]
        extra.update({f"{key}_ms": o["ms"],
                      f"{key}_device_ms": o["device_ms"],
                      f"{key}_plain_ms": o["plain_ms"],
                      f"{key}_bound_ms": k3_bound_ms(*o["bound"][:3])[0],
                      f"{key}_shape": f"T={o['T']} R={o['R']} {o['variant']}"})
    extra["hist_placement_device_ms"] = {
        key: {k: timings[f"k3_{key}"][k]
              for k in ("plan_hist", "shared_device_ms", "global_device_ms")}
        for key in K3_BENCH}
    extra.update({
        "renorm": {str(N): {k: v for k, v in r.items() if k != "bound"}
                   for N, r in t["renorm"].items()},
        "renorm_turns_ms": t["turns"],
        "renorm_parity": report["k3_renorm_parity"]})
    kernels.append(dict({
        "name": "bcjr_appdiff", "route": "cuda", "source": BCJR_SOURCE,
        "replaces": "commpy_tpu/kernels/bcjr.py:296",
        "launches": sum(path_launches["bcjr_appdiff"].values()),
        "path_launches": path_launches["bcjr_appdiff"],
        "mismatches": k3_tally.mismatches, "compared": k3_tally.compared,
        "bit_diffs": k3_tally.bit_diffs, "max_abs_err": k3_tally.max_abs_err,
        "ms": t["ms"], "kernel_ms": t["ms"], "device_ms": t["device_ms"],
        "ms_note": MS_NOTE, "plain_ms": t["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "store_bound_ms": t["bound"][3] / HBM_BYTES_PER_S * 1e3,
        "bound_note": "bound_ms counts the streams in and e out once; the "
        "history is scratch of this design, written and read once: "
        "store_bound_ms, at device memory's rate",
        "redesigned": True,
        "shape": "T=128 R=12288 S=4 boundary, log-MAP f32 (Path C: L=6144, "
                 "F=256, NII (128, 0))"}, **extra))
    k6 = report["k6"]
    t6, t6l = k6["timing"]["bcc_step"], k6["timing"]["ldpc_step"]
    kernels.append({
        "name": "demap_joint", "route": "cuda", "source": DEMAP_SOURCE,
        "replaces": None,
        "replaces_note": "no TPU kernel: the JAX package leaves the "
        "demapper to XLA (commpy_tpu/ops/modem.py:258-259)",
        "launches": sum(path_launches["demap_joint"].values()),
        "path_launches": path_launches["demap_joint"],
        "plain_joint_cuda_calls": k6w.plain_cuda,
        "mismatches": k6["mismatches"], "compared": k6["llrs"],
        "symbols_compared": k6["symbols"], "max_ulp": k6["max_ulp"],
        "ms": t6["ms"], "kernel_ms": t6["ms"], "device_ms": t6["device_ms"],
        "ms_note": MS_NOTE, "plain_ms": t6["plain_ms"],
        "separable_ms": t6["separable_ms"], "maxlog_ms": t6["maxlog_ms"],
        "bound_ms": t6["bound_ms"], "bound_by": t6["bound_by"],
        "library_ms": None, "redesigned": True,
        "shape": "16-QAM, 2048 x 2688 symbols (a step of mcs4-bcc)",
        "second_ms": t6l["ms"], "second_device_ms": t6l["device_ms"],
        "second_plain_ms": t6l["plain_ms"],
        "second_separable_ms": t6l["separable_ms"],
        "second_bound_ms": t6l["bound_ms"],
        "second_shape": "16-QAM, 4096 x 486 symbols (a step of the LDPC "
                        "cells)"})
    report["kernels"] = kernels
    lap("timing")
    if "--ab" in sys.argv:
        other_root = sys.argv[sys.argv.index("--ab") + 1]
        OK, OQ, OM = load_other_port(other_root)
        meta4 = (p1944["Z"], p1944["Nb"], Q.qc_rows(p1944))
        ok4 = dict(algorithm="MSA", n_iters=15, meta=meta4)
        ok4l = dict(algorithm="MSA", n_iters=8, meta=meta4,
                    schedule="layered")
        links = {"mcs4": (link, OM.wifi80211_device_link(
                     4, frame_bits=1200, device="cuda"), 2048, ns),
                 "path_a": (ldpc_link, OM.wifi80211n_ldpc_link(1944, 16),
                            512, ns_a)}

        def step(lk, frames, noise):
            # both trees draw the same bits and noise: equal error counts
            g = torch.Generator(device=dev)
            g.manual_seed(21)
            return (lk.link_step(g, frames, noise),)
        report["ab"] = {"other": other_root, "card": card, **ab_compare(
            torch, {
                "k1_mcs4": ("acs_", lambda: K.acs_forward(r_mcs4, C7),
                            lambda: OK.acs_forward(r_mcs4, C7)),
                "k1_bench": ("acs_", lambda: K.acs_forward(r_bench, C7),
                             lambda: OK.acs_forward(r_bench, C7)),
                **{f"k2_{k}": ("traceback",
                               lambda v=v: (K.traceback(*v, 64, 30),),
                               lambda v=v: (OK.traceback(*v, 64, 30),))
                   for k, v in tb_inputs.items()},
                "k4_flooding15": ("qc_bp_resident_kernel",
                                  lambda: QK.qc_bp_resident(x4, **ok4),
                                  lambda: OQ.qc_bp_resident(x4, **ok4)),
                "k4_layered8": ("qc_bp_resident_kernel",
                                lambda: QK.qc_bp_resident(x4l, **ok4l),
                                lambda: OQ.qc_bp_resident(x4l, **ok4l)),
                **{f"{k}_link_step": (None, lambda v=v: step(v[0], *v[2:]),
                                      lambda v=v: step(v[1], *v[2:]))
                   for k, v in links.items()},
            })}
        lap("ab")
    report["phase_s"] = phase_s
    report["seconds"] = time.perf_counter() - t_start
    print(json.dumps({
        "decoded_info_bits_per_s": decoded_bps,
        "decoder_config": "K=7 soft, B=2048, L=1024, tb_depth=30",
        "mcs4_link_info_bits_per_s": link_bps,
        "link_config": "802.11 MCS-4, frame_bits=1200, F=2048, 12 dB",
        "80211n_ldpc_link_info_bits_per_s": ldpc_bps,
        "ldpc_link_config": "802.11n LDPC (1944, 972), 16-QAM, MSA "
                            "flooding-15, F=512, 10 dB",
        "turbo_decoder_info_bits_per_s": turbo_rates,
        "turbo_decoder_config": "4-state RSC (1, 7/5), log-MAP, 8 "
                                "iterations, randn frames, nv 0.5",
        "turbo_link_info_bits_per_s": turbo_bps,
        "turbo_link_config": "rate 1/3, L=6144, RandInterlv(6144, 0), NII "
                             "(128, 0), F=256, Eb/N0 1.0 dB",
        "mimo_ofdm_link_info_bits_per_s": {
            k: report[k]["timing"]["info_bits_per_s"]
            for k in ("path_d", "path_e", "path_f", "path_g")},
        "mimo_ofdm_link_configs": {
            "path_d": "K-best(16) 4x4 16-QAM uncoded, F=2048, 16.02 dB",
            "path_e": "best-first(32) 4x4 16-QAM + WiMAX LDPC (1440, 720) "
                      "MSA-15, F=512, 18 dB",
            "path_f": "OFDM 2x2 16-QAM K-best(8) + K=7 soft Viterbi, "
                      "F=2048, 14 dB",
            "path_g": "OFDM 802.11n LDPC (1944, 1/2) 16-QAM, 4-tap "
                      "Rayleigh, LS CSI, F=512, 13 dB"},
        "dsp_code_link_info_bits_per_s": {
            "path_h": report["path_h"]["timing"]["info_bits_per_s"],
            "path_i": report["path_i"]["timing"]["info_bits_per_s"],
            "path_j": report["path_j"]["timing"]["info_bits_per_s"],
            "path_k": {d: t["info_bits_per_s"]
                       for d, t in report["path_k"]["timing"].items()},
            "path_l": report["path_l"]["timing"]["info_bits_per_s"]},
        "dsp_code_link_configs": {
            "path_h": "RRC (sps 4, span 8, 0.35) 16-QAM + K=7 soft Viterbi, "
                      "max-log, F=2048, 12 dB",
            "path_i": "ISI H3 + MMSE-21 QPSK + K=7 soft Viterbi, F=2048, "
                      "8 dB",
            "path_j": "BCH (31,21) BPSK Chase-4 link, F=4096, 4 dB",
            "path_k": "RS(204,188) fcr=0 256-QAM link, hard and GMD, "
                      "F=2048, 15 dB",
            "path_l": "DVB-S2 BCH t=12 + LDPC (16200, 1/2) QPSK MSA-30 "
                      "layered, F=512, 5 dB"},
        "decoder_info_bits_per_s": {
            "bch_dvbs2_16200_t12":
                report["path_j"]["bch_dvbs2_16200_t12"]["info_bits_per_s"],
            "tpc_31_21_sq_chase4":
                report["path_j"]["tpc_31_21_sq_chase4"]["info_bits_per_s"],
            "rs_255_223_t16":
                report["path_k"]["rs_255_223_t16"]["info_bits_per_s"]},
        "equalize_mmse_t31_l5_msamples_per_s":
            report["equalize_mmse_t31_l5"]["msamples_per_s"],
        "polar_idd_link_info_bits_per_s": {
            "path_m": report["path_m"]["timing"]["info_bits_per_s"],
            "path_n": report["path_n"]["timing"]["info_bits_per_s"]},
        "polar_idd_link_configs": {
            "path_m": "polar (1024, 512) CRC-11 QPSK SCL-8 (unrolled), "
                      "F=512, Eb/N0 2 dB",
            "path_n": "IDD K-best(16) 4x4 16-QAM + WiMAX LDPC (1440, 720) "
                      "MSA-15, n_it=1, F=512, 18 dB"},
        "polar_decoder_info_bits_per_s": {
            k: v["info_bits_per_s"]
            for k, v in report["path_m"]["decoders"].items()},
        "parallel_paths": {
            "path_p_round_ms": report["path_p"]["round_ms_mesh"],
            "path_p_info_bits_per_s": report["path_p"]["info_bits_per_s"],
            "path_q_viterbi_stream_info_bits_per_s":
                report["path_q"]["viterbi"]["info_bits_per_s"],
            "path_q_turbo_stream_info_bits_per_s": {
                m: t["info_bits_per_s"]
                for m, t in report["path_q"]["turbo"].items()},
            "path_r_info_bits_per_s": {
                k: v["info_bits_per_s"] for k, v in report["path_r"].items()
                if "info_bits_per_s" in v},
            "path_r_fir_msamples_per_s":
                report["path_r"]["fir_2p22_rrc"]["msamples_per_s"]},
        "parallel_configs": {
            "path_p": "MCS-4 F=2048 12 dB, montecarlo_ber(mesh=make_mesh()), "
                      "world 1, NCCL",
            "path_q": "Viterbi stream L=2^20 K=7 soft BPSK Eb/N0 3 dB; turbo "
                      "stream L=6144 RSC (1, 7/5) 8 it Eb/N0 2 dB",
            "path_r": "ldpc sharded 802.11n 1944 B=512 MSA-15; QC sharded "
                      "DVB-S2-class 16200 B=512 MSA flooding-15; FIR 2^22"},
        "compatible_api": {
            "wifi80211_mcs4_12db_ber": report["path_o"]["wifi80211"]["ber"],
            "wifi80211_ms_per_chunk":
                report["path_o"]["wifi80211"]["ms_per_chunk"],
            "device_link_ber": report["path_o"]["wifi80211"][
                "device_link_ber"]},
        "card": card, "seconds": report["seconds"], "phase_s": phase_s}),
        flush=True)
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
