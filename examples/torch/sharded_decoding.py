"""Mesh-parallel decoding demos: sequence, tensor and pipeline parallelism.

Counterpart of ``examples/sharded_decoding.py`` on the PyTorch port.
One process drives one device, so the demos are SPMD: every rank runs
them on its own shard, and the ranks meet in ``torch.distributed``
collectives (NCCL on GPUs, gloo on the host).

1. sequence parallelism: ONE long turbo frame split along time over the
   ranks, BCJR state metrics exchanged as halos (warmup) or as boundary
   metrics between iterations (NII), against the windowed serial
   decoder; each MAP pass runs the BCJR kernel, renormalising its
   metrics every step as the reference normalises them;
2. tensor parallelism: ONE LDPC Tanner graph's check rows split over the
   ranks, against the single-device decoder;
3. pipeline parallelism: four link stages composed onto the ranks;
4. the sequence-sharded Viterbi stream and the overlap-save FIR against
   their serial counterparts.

On a GPU it runs at world size 1; ``--device cpu --ranks D`` starts D
gloo rank processes through ``parallel.dryrun.spawn_ranks`` and reports
rank 0's numbers.

Run:  python examples/torch/sharded_decoding.py                (GPU)
      python examples/torch/sharded_decoding.py --device cpu --ranks 4
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from commpy_tpu_torch.ops.convcode import conv_encode  # noqa: E402
from commpy_tpu_torch.ops.fir import fir_filter, sharded_fir_filter  # noqa: E402,E501
from commpy_tpu_torch.ops.interleave import RandInterlv  # noqa: E402
from commpy_tpu_torch.ops.ldpc import (  # noqa: E402
    DESIGNS, get_ldpc_code_params, ldpc_bp_decode_device,
    ldpc_bp_decode_sharded)
from commpy_tpu_torch.ops.stream import (  # noqa: E402
    sharded_turbo_stream, sharded_viterbi_stream)
from commpy_tpu_torch.ops.trellis import Trellis  # noqa: E402
from commpy_tpu_torch.ops.turbo import (  # noqa: E402
    turbo_decode_device, turbo_encode_device)
from commpy_tpu_torch.ops.viterbi import viterbi_decode_device  # noqa: E402
from commpy_tpu_torch.parallel import (NamedSharding, P, distributed,  # noqa: E402,E501
                                       make_mesh, pipeline_map)
from commpy_tpu_torch.parallel.dryrun import spawn_ranks  # noqa: E402
from commpy_tpu_torch.utils.device import resolve_device  # noqa: E402


def demos(mesh, dev, *, turbo_per_rank=512, n_iterations=6):
    """The four demos on this rank's shards of ``mesh`` (axis 'dp');
    returns the same numbers on every rank, ``ldpc_decisions`` the
    edge-sharded decoder's [8, 1440] int8 decisions."""
    D = mesh.size()
    rank0 = mesh.get_local_rank() == 0
    split = NamedSharding(mesh, P("dp"))
    rng = np.random.RandomState(1)
    out = {"ranks": D}

    def report(text):
        if rank0:
            print(text, flush=True)

    def host(x):
        return x.cpu().numpy()

    report(f"mesh: {D} x {dev.type}")

    # --- sequence-sharded turbo: one frame across the ranks -------------
    L = turbo_per_rank * D
    trellis = Trellis(np.array([2]), np.array([[1, 7]]), 5, "rsc")
    p = RandInterlv(L, 0).p_array
    msg = rng.randint(0, 2, L).astype(np.int8)
    coded = turbo_encode_device(msg, trellis, trellis, p, device=dev)
    sigma = 0.9
    sy, pa1, pa2 = (torch.as_tensor(((2.0 * host(b) - 1) + rng.randn(L)
                                     * sigma).astype(np.float32), device=dev)
                    for b in coded)

    def stream(mode, **kw):
        bits = sharded_turbo_stream(
            split.shard(sy), split.shard(pa1), split.shard(pa2), trellis,
            sigma ** 2, n_iterations, p, mesh, axis_name="dp",
            boundary_init=mode, **kw)
        return host(split.gather(bits))

    dec_sharded = stream("warmup", warmup=64)
    # NII: boundary alpha/beta ride ring shifts between iterations
    # instead of warmup halos (2 x S floats a pass, no halo recompute)
    dec_nii = stream("nii")
    dec_serial = host(turbo_decode_device(sy, pa1, pa2, trellis, sigma ** 2,
                                          n_iterations, p, window=(256, 64),
                                          device=dev))
    out.update({
        "turbo_L": L,
        "turbo_ber": {"warmup": float(np.mean(dec_sharded != msg)),
                      "nii": float(np.mean(dec_nii != msg)),
                      "serial": float(np.mean(dec_serial != msg))},
        "turbo_sharded_eq_serial": float(np.mean(dec_sharded == dec_serial))})
    report(f"turbo {L}-bit frame: sharded BER "
           f"{out['turbo_ber']['warmup']:.4f}, NII BER "
           f"{out['turbo_ber']['nii']:.4f}, serial BER "
           f"{out['turbo_ber']['serial']:.4f}, sharded==serial on "
           f"{out['turbo_sharded_eq_serial']:.4%} of bits")

    # --- edge-sharded LDPC: one Tanner graph across the ranks -----------
    params = get_ldpc_code_params(os.path.join(DESIGNS, "wimax",
                                               "1440.720.txt"))
    llr = torch.as_tensor(rng.randn(8, 1440).astype(np.float32) * 2 + 1.0,
                          device=dev)
    dec_s, _ = ldpc_bp_decode_sharded(llr, params, "MSA", 10, mesh, "dp")
    dec_1, _ = ldpc_bp_decode_device(llr, params, "MSA", 10, device=dev)
    out["ldpc_decisions"] = host(dec_s)
    out["ldpc_equal"] = bool(torch.equal(dec_s, dec_1))
    report(f"LDPC(1440,720) edge-sharded over {D} ranks: decisions "
           f"identical to single-device: {out['ldpc_equal']}")

    # --- pipeline parallelism: link stages across the ranks -------------
    # the wire is [2, N]: row 0 carries the signal, row 1 the payload bits
    ops = [lambda w: torch.stack([2.0 * w[1] - 1.0, w[1]]),  # BPSK map
           lambda w: torch.stack([w[0] * 0.8, w[1]]),  # channel gain
           lambda w: torch.stack([2.0 * w[0] / 0.25, w[1]]),  # LLR demap
           lambda w: torch.stack([(w[0] > 0).to(w.dtype), w[1]])]  # slice
    per = -(-len(ops) // D)

    def compose(fs):
        def stage(w):
            for f in fs:
                w = f(w)
            return w
        return stage

    stages = [compose(ops[i * per:(i + 1) * per]) for i in range(D)]
    bits_pp = rng.randint(0, 2, (6, 128)).astype(np.float32)
    wire = torch.as_tensor(np.stack([np.zeros_like(bits_pp), bits_pp], 1),
                           device=dev)
    got = pipeline_map(stages, wire, make_mesh(D, "pp", device=dev),
                       axis_name="pp")
    out["pipeline_eq_payload"] = float(np.mean(host(got[:, 0]) == bits_pp))
    report(f"pipeline over {D} ranks: {wire.shape[0]} microbatches, "
           f"decisions == payload on {out['pipeline_eq_payload']:.0%} of "
           f"bits")

    # --- sequence-sharded streams: Viterbi and FIR overlap-save ---------
    # a continuous coded stream split along time; each rank decodes its
    # shard plus warmup/lookahead halos from its neighbours
    tr_cc = Trellis(np.array([2]), np.array([[5, 7]]))
    L_st = 1024 * D
    msg_st = rng.randint(0, 2, L_st).astype(np.int8)
    cc = conv_encode(msg_st, tr_cc, termination="cont", device=dev)
    llrs = torch.as_tensor(((2.0 * cc - 1) + rng.randn(cc.shape[-1]) * 0.6)
                           .astype(np.float32), device=dev)
    dec_stream = host(split.gather(sharded_viterbi_stream(
        split.shard(llrs), tr_cc, mesh, decoding_type="unquantized",
        axis_name="dp")))
    dec_ser = host(viterbi_decode_device(llrs, tr_cc,
                                         decoding_type="unquantized",
                                         device=dev))
    out["viterbi_ber"] = float(np.mean(dec_stream != msg_st))
    out["viterbi_equal"] = bool(np.array_equal(dec_stream, dec_ser))
    report(f"viterbi stream {L_st} bits over {D} ranks: BER "
           f"{out['viterbi_ber']:.4f}, sharded == serial: "
           f"{out['viterbi_equal']}")
    # the filter tail crossing each shard boundary rides one ring shift
    # to the right neighbour, no full-signal gather
    taps = np.hanning(65).astype(np.float32)
    wave = torch.as_tensor(rng.randn(4096 * D).astype(np.float32),
                           device=dev)
    y_sh = split.gather(sharded_fir_filter(split.shard(wave), taps, mesh,
                                           "dp"))
    y_ser = fir_filter(wave, taps, "full", device=dev)[:wave.shape[0]]
    out["fir_max_err"] = float((y_sh - y_ser).abs().max())
    report(f"sharded FIR overlap-save: max |sharded - serial| = "
           f"{out['fir_max_err']:.2e}")
    return out


def _rank(args):
    """One rank of a spawned group: run the demos, rank 0 saves them."""
    import torch.distributed as dist

    distributed.initialize(args.init, args.ranks, args.rank,
                           device=args.device)
    try:
        dev = resolve_device(args.device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        out = demos(make_mesh(args.ranks, "dp", device=dev), dev,
                    turbo_per_rank=args.turbo_per_rank,
                    n_iterations=args.iterations)
        if args.rank == 0:
            torch.save(out, args.out)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def main(device="cuda", *, ranks=1, timeout=600.0, **sizes):
    """The demos at world size ``ranks``: 1 runs them in this process
    (the GPU, or the host with ``device='cpu'``); D > 1 starts D rank
    processes (gloo for 'cpu', NCCL over D GPUs for 'cuda') and returns
    rank 0's numbers.  ``sizes``: :func:`demos`'s keywords."""
    dev = resolve_device(device)
    if int(ranks) == 1:
        return demos(make_mesh(device=dev), dev, **sizes)
    extra = []
    for key, flag in (("turbo_per_rank", "--turbo-per-rank"),
                      ("n_iterations", "--iterations")):
        if key in sizes:
            extra += [flag, str(int(sizes.pop(key)))]
    if sizes:
        raise TypeError(f"unknown sizes {sorted(sizes)}")
    with tempfile.TemporaryDirectory(prefix="sharded_decoding_") as tmp:
        path = os.path.join(tmp, "rank0.pt")
        outs = spawn_ranks([sys.executable, os.path.abspath(__file__),
                            "--device", dev.type, "--ranks", str(ranks),
                            "--out", path] + extra, int(ranks), timeout)
        print(outs[0], end="")
        return torch.load(path, weights_only=False)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--turbo-per-rank", type=int, default=512,
                    help="turbo frame bits a rank")
    ap.add_argument("--iterations", type=int, default=6,
                    help="turbo iterations")
    ap.add_argument("--rank", type=int, default=None,
                    help="run one rank of a spawned group")
    ap.add_argument("--init", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.rank is None:
        main(a.device, ranks=a.ranks, turbo_per_rank=a.turbo_per_rank,
             n_iterations=a.iterations)
    else:
        _rank(a)
