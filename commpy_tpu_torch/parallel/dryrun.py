"""One pass over every sharded path on n ranks: the port's multi-device
smoke test.

Counterpart of ``__graft_entry__.dryrun_multichip``.  It starts n rank
processes of this module (gloo on the host, NCCL on n GPUs), which meet
through a ``file://`` store in a temporary directory and each run, on a
1-D mesh of the n ranks: one data-parallel round of the 802.11 MCS-4
link, of a polar SCL + CRC link and of the OFDM LDPC link with
estimated CSI; the sequence-parallel turbo stream; the edge-sharded
dense LDPC decoder and the Z-sharded QC decoders (a random QC code and
5G NR BG2); and a four-stage link pipeline.  Each rank checks its
outputs' shapes and the pipeline's decisions and exits 0.

    python -m commpy_tpu_torch.parallel.dryrun 4 --device cpu

or :func:`dryrun_multichip` from Python.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

__all__ = ["dryrun_multichip", "spawn_ranks"]

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn_ranks(argv, n_ranks: int, timeout: float = 600.0) -> list:
    """Run ``argv + ['--rank', r, '--init', init]`` as ``n_ranks`` processes
    that meet through a ``file://`` store in a temporary directory; this
    package is importable in them.  Returns each rank's output (stdout and
    stderr); raises ``RuntimeError`` with the failing ranks' output when a
    rank fails or outlives ``timeout`` seconds, and stops every process
    it started."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory(prefix="commpy_ranks_") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        procs = [subprocess.Popen(
            list(argv) + ["--rank", str(r), "--init", init], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(int(n_ranks))]
        outs = []
        try:
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=timeout)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append(p.communicate()[0] + "\n(timed out)")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode]
    if bad:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"--- rank {r} exit {rc}\n{o[-4000:]}" for r, rc, o in bad))
    return outs


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0):
    """Run every sharded path once on ``n_devices`` ranks.

    ``device='cpu'`` runs gloo ranks on the host; ``'cuda'`` runs NCCL
    ranks, one a GPU, and needs ``n_devices`` GPUs.  Raises
    ``RuntimeError`` with the failing ranks' output when a rank fails,
    and stops every rank it started.
    """
    import torch

    n = int(n_devices)
    if torch.device(device).type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"{n} NCCL ranks need {n} GPUs; this process "
                           f"sees {torch.cuda.device_count()}")
    spawn_ranks([sys.executable, "-m", "commpy_tpu_torch.parallel.dryrun",
                 str(n), "--device", str(device)], n, timeout)


def _expect(ok, what) -> None:
    if not ok:
        raise RuntimeError(f"dryrun check failed: {what}")


def _run_rank(n: int, rank: int, init: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    from ..models import (make_ofdm_qcldpc_link, make_polar_awgn_link,
                          wifi80211_device_link)
    from ..ops.interleave import RandInterlv
    from ..ops.ldpc import (DESIGNS, get_ldpc_code_params,
                            ldpc_bp_decode_sharded)
    from ..ops.nrldpc import nr_code_params, nr_lifting_sizes
    from ..ops.polar import polar_construct
    from ..ops.qcldpc import (ieee80211n_params, qc_bp_decode_sharded,
                              random_qc_params)
    from ..ops.stream import sharded_turbo_stream
    from ..ops.trellis import Trellis
    from . import distributed, make_mesh, make_round_fn, pipeline_map
    from .mesh import NamedSharding, P

    distributed.initialize(init, n, rank, device=device)
    try:
        mesh = make_mesh(n, "dp", device=device)
        dev = torch.device(device if torch.device(device).type == "cpu"
                           else f"cuda:{torch.cuda.current_device()}")
        rng = np.random.RandomState(0)

        # data parallel: the frame axis of each round over the ranks
        link = wifi80211_device_link(mcs=4, frame_bits=384, device=dev)
        stds = [float(link.noise_std_fn(s)) for s in (8.0, 10.0, 12.0)]
        errs = make_round_fn(link.link_step, stds, 2 * n, dev, mesh)(0, 0)
        _expect(errs.shape == (3,), errs.shape)
        pcode = polar_construct(64, 32, crc="crc6", design_snr_db=2.0)
        plink = make_polar_awgn_link(code=pcode, decoder="scl",
                                     list_size=2, device=dev)
        perrs = make_round_fn(plink.link_step,
                              [float(plink.noise_std_fn(4.0))], 2 * n, dev,
                              mesh)(0, 1)
        _expect(perrs.shape == (1,), perrs.shape)
        olink = make_ofdm_qcldpc_link(
            qc_params=ieee80211n_params(648, "1/2"), modulation_m=4,
            nfft=64, nsc=54, n_taps=4, csi="smooth", n_iterations=3,
            device=dev)
        oerrs = make_round_fn(olink.link_step,
                              [float(olink.noise_std_fn(8.0))], n, dev,
                              mesh)(0, 2)
        _expect(oerrs.shape == (1,), oerrs.shape)

        # sequence parallel: one turbo frame along time over the ranks
        T = 64 * n
        trt = Trellis(np.array([2]), np.array([[1, 7]]), 5, "rsc")
        x = torch.as_tensor(rng.randn(3, T).astype(np.float32), device=dev)
        local = NamedSharding(mesh, P("dp")).shard
        bits = sharded_turbo_stream(
            local(x[0]), local(x[1]), local(x[2]), trt, 1.0, 2,
            RandInterlv(T, 0).p_array, mesh, warmup=16, axis_name="dp")
        _expect(tuple(bits.shape) == (T // n,), bits.shape)

        # tensor parallel: one LDPC graph's check rows over the ranks
        params = get_ldpc_code_params(os.path.join(DESIGNS, "gallager",
                                                   "96.33.964.txt"))
        llr = torch.as_tensor(rng.randn(4, 96).astype(np.float32) * 2,
                              device=dev)
        dec, _ = ldpc_bp_decode_sharded(llr, params, "MSA", 5, mesh, "dp")
        _expect(tuple(dec.shape) == (4, 96), dec.shape)
        # the QC form: the circulant axis over the ranks
        qp = random_qc_params(4, 8, 2 * n, col_weight=3, seed=1)
        qllr = torch.as_tensor(
            rng.randn(2, qp["n_vnodes"]).astype(np.float32) * 2, device=dev)
        qdec, _ = qc_bp_decode_sharded(qllr, qp, "MSA", 3, mesh, "dp")
        _expect(tuple(qdec.shape) == (2, qp["n_vnodes"]), qdec.shape)
        znr = next(z for z in nr_lifting_sizes()
                   if z % n == 0 and z >= 2 * n)
        npms = nr_code_params(2, znr)
        nllr = torch.as_tensor(
            rng.randn(2, npms["n_vnodes"]).astype(np.float32) * 2,
            device=dev)
        ndec, _ = qc_bp_decode_sharded(nllr, npms, "MSA", 3, mesh, "dp")
        _expect(tuple(ndec.shape) == (2, npms["n_vnodes"]), ndec.shape)

        # pipeline: the link's stages over the ranks, composed into n
        def tx(w):
            return torch.stack([2.0 * w[1] - 1.0, w[1]])

        def chan(w):
            return torch.stack([w[0] * 0.9, w[1]])

        def demap(w):
            return torch.stack([w[0] * 4.0, w[1]])

        def slicer(w):
            return torch.stack([(w[0] > 0).to(w.dtype), w[1]])

        ops = [tx, chan, demap, slicer]
        per = -(-len(ops) // n)

        def compose(fs):
            def g(w):
                for f in fs:
                    w = f(w)
                return w
            return g

        stages = [compose(ops[i * per:(i + 1) * per]) for i in range(n)]
        bits_w = rng.randint(0, 2, (3, 64)).astype(np.float32)
        wire = torch.as_tensor(np.stack([np.zeros_like(bits_w), bits_w], 1),
                               device=dev)
        out = pipeline_map(stages, wire, mesh, axis_name="dp")
        _expect(np.array_equal(out[:, 0].cpu().numpy(), bits_w),
                "the pipeline's decisions")
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        # every rank done with its sends before any tears the group down
        dist.barrier()
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None,
                    help="run one rank (started by dryrun_multichip)")
    ap.add_argument("--init", default=None)
    args = ap.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n_devices, args.device)
        print(f"dryrun of {args.n_devices} ranks on {args.device}: ok")
    else:
        _run_rank(args.n_devices, args.rank, args.init, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
