"""The port's sequence-parallel streams and sharded FIR against the JAX
package's, on D = 2 and 4 ranks.

The JAX functions run here on ``commpy_tpu.parallel.make_mesh(D)`` over
the virtual CPU devices; the port's run in D gloo rank processes
(``commpy_tpu_torch.parallel.dryrun.spawn_ranks``, a ``file://`` store),
which import neither ``jax`` nor ``commpy_tpu``: one group of ranks a D
runs every case and hands rank 0's results back as ``.npz``.  Each rank
calls the SPMD functions on its own shard; ``shard_map`` gathers the
whole stream.

Held: the Viterbi stream's bits equal (the cases of ``test_stream.py``,
L = 512 D); the turbo stream's decisions equal in the 'warmup' and 'nii'
modes and at warmup=0 (L = 1024 D, 3 iterations), with
``test_stream.py``'s serial-mismatch and message checks on the port's
outputs, on the default route (K3's, its plain version here), and the
``_bcjr_masked`` route (``backend='torch'``) deciding as it; one MAP
pass of the two routes within 1e-5 (1 + |x|) from T = 288 to 6144 (the
kernel route renormalises its metrics); the sharded FIR within 1e-5 of
the JAX package's and of the port's ``fir_filter(x, taps, 'full')[:n]``.  At
``warmup_codewords=0`` the JAX stream's halo is the whole shard
(``x_local[-0:]``, ``commpy_tpu/ops/stream.py:82``) and its BER is about
a half; the port's halo is empty and it decodes as the serial decoder
but at the shard boundaries.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commpy_tpu.channelcoding import RandInterlv as JRandInterlv
from commpy_tpu.ops import turbo as JT
from commpy_tpu.ops.convcode import conv_encode as j_conv_encode
from commpy_tpu.ops.fir import sharded_fir_filter as j_sharded_fir
from commpy_tpu.ops.stream import (sharded_turbo_stream as j_turbo_stream,
                                   sharded_viterbi_stream as j_vit_stream)
from commpy_tpu.ops.trellis import Trellis as JTrellis
from commpy_tpu.parallel import make_mesh as j_make_mesh

from commpy_tpu_torch.ops import fir as PF
from commpy_tpu_torch.ops import turbo as PT
from commpy_tpu_torch.ops.trellis import Trellis
from commpy_tpu_torch.ops.viterbi import viterbi_decode_device
from commpy_tpu_torch.parallel.dryrun import spawn_ranks

torch.set_num_threads(1)

CPU = "cpu"
DS = (2, 4)
K3 = ([2], [[5, 7]])
K7 = ([6], [[0o133, 0o171]])
RSC = ([2], [[1, 7]], 5, "rsc")

WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
D, inp, outp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
rank = int(sys.argv[sys.argv.index("--rank") + 1])
init = sys.argv[sys.argv.index("--init") + 1]
from commpy_tpu_torch.ops.fir import sharded_fir_filter
from commpy_tpu_torch.ops.stream import (sharded_turbo_stream,
                                         sharded_viterbi_stream)
from commpy_tpu_torch.ops.trellis import Trellis
from commpy_tpu_torch.parallel import P, distributed, make_mesh, shard_map

distributed.initialize(init, D, rank, device="cpu")
mesh = make_mesh(D, "sp", device="cpu")
x = {k: torch.as_tensor(v) for k, v in np.load(inp).items()}
sp = P("sp")
k3 = Trellis(np.array([2]), np.array([[5, 7]]))
k7 = Trellis(np.array([6]), np.array([[0o133, 0o171]]))
rsc = Trellis(np.array([2]), np.array([[1, 7]]), 5, "rsc")


def vit(tr, tb, w):
    return shard_map(lambda c: sharded_viterbi_stream(
        c, tr, mesh, tb_depth=tb, warmup_codewords=w), mesh, sp, sp)


def turbo(key, iters, **kw):
    y = x[key]
    return shard_map(lambda a, b, c: sharded_turbo_stream(
        a, b, c, rsc, float(x[key + "_nv"]), iters, x[key + "_p"].numpy(),
        mesh, **kw), mesh, (sp, sp, sp), sp)(y[0], y[1], y[2])


res = {
    "vit_k3": vit(k3, 15, 96)(x["vit_k3"]),
    "vit_k7": vit(k7, 30, 128)(x["vit_k7"]),
    "vit_k7_w0": vit(k7, 30, 0)(x["vit_k7"]),
    "turbo_warmup": turbo("turbo_warmup", 3, warmup=64),
    "turbo_warmup_torch": turbo("turbo_warmup", 3, warmup=64,
                                backend="torch"),
    "turbo_nii": turbo("turbo_nii", 3, boundary_init="nii"),
    "turbo_nii_torch": turbo("turbo_nii", 3, boundary_init="nii",
                             backend="torch"),
    "turbo_w0": turbo("turbo_w0", 2, warmup=0),
    "fir": shard_map(lambda v: sharded_fir_filter(v, x["fir_taps"], mesh),
                     mesh, sp, sp)(x["fir_x"]),
}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "commpy_tpu"))
if bad:
    raise SystemExit(f"a rank imported {bad}")
if rank == 0:
    np.savez(outp, **{k: v.numpy() for k, v in res.items()})
dist.barrier()
dist.destroy_process_group()
'''


def _turbo_case(L, seed, interlv_seed, scale=None):
    """One frame of the JAX turbo test's kind: (message, [3, L] received
    symbols, noise variance, interleaver)."""
    rng = np.random.RandomState(seed)
    tr = JTrellis(*map(np.array, RSC[:2]), *RSC[2:])
    p = JRandInterlv(L, interlv_seed).p_array
    msg = rng.randint(0, 2, (1, L))
    s, p1, p2 = JT.turbo_encode_device(msg, tr, tr, p)
    x = np.stack([2.0 * np.asarray(c)[0] - 1 for c in (s, p1, p2)])
    if scale is None:
        sigma2 = 0.5
        y = x + rng.randn(3, L) * np.sqrt(sigma2)
    else:  # clean and scaled, as the JAX warmup=0 test
        sigma2, y = 0.5, x * scale
    return msg[0], y.astype(np.float32), np.float32(sigma2), p


def _inputs(D):
    """Every case's inputs at D ranks; the JAX tests' seeds, L shrunk."""
    cases, msgs = {}, {}
    for name, tr_args, seed, scale in (("vit_k3", K3, 11, 4.0),
                                       ("vit_k7", K7, 12, 5.0)):
        rng = np.random.RandomState(seed)
        L = 512 * D
        msg = rng.randint(0, 2, L)
        coded = j_conv_encode(msg, JTrellis(*map(np.array, tr_args)),
                              "cont").astype(np.float32)
        cases[name] = ((2.0 * coded - 1) * scale
                       + rng.randn(coded.size) * 2.0).astype(np.float32)
        msgs[name] = msg
    for name, seed, iseed, scale in (("turbo_warmup", 13, 0, None),
                                     ("turbo_nii", 17, 1, None),
                                     ("turbo_w0", 23, 0, 4.0)):
        msg, y, nv, p = _turbo_case(1024 * D, seed, iseed, scale)
        cases.update({name: y, name + "_nv": nv, name + "_p": p})
        msgs[name] = msg
    rng = np.random.RandomState(31)
    n = 1024 * D
    cases["fir_x"] = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    cases["fir_taps"] = rng.randn(33).astype(np.float32)
    return cases, msgs


def _jax_jobs(D, x):
    """The JAX side's calls at D devices, one a case: {name: thunk}."""
    mesh = j_make_mesh(D, "sp")
    jobs = {}
    for name, tr_args, tb, w in (("vit_k3", K3, 15, 96),
                                 ("vit_k7", K7, 30, 128),
                                 ("vit_k7_w0", K7, 30, 0)):
        jobs[name] = (lambda name=name, tr_args=tr_args, tb=tb, w=w:
                      j_vit_stream(x[name[:6]],
                                   JTrellis(*map(np.array, tr_args)), mesh,
                                   tb_depth=tb, decoding_type="soft",
                                   warmup_codewords=w))
    tr = JTrellis(*map(np.array, RSC[:2]), *RSC[2:])
    for name, iters, kw in (("turbo_warmup", 3, {"warmup": 64}),
                            ("turbo_nii", 3, {"boundary_init": "nii"}),
                            ("turbo_w0", 2, {"warmup": 0})):
        y = x[name]
        jobs[name] = (lambda y=y, name=name, iters=iters, kw=kw:
                      j_turbo_stream(y[0], y[1], y[2], tr,
                                     float(x[name + "_nv"]), iters,
                                     x[name + "_p"], mesh, **kw))
    jobs["fir"] = lambda: j_sharded_fir(jnp.asarray(x["fir_x"]),
                                        jnp.asarray(x["fir_taps"]), mesh)
    return jobs


def _port_results(D, x, tmp):
    inp, outp = os.path.join(tmp, f"in{D}.npz"), os.path.join(tmp,
                                                              f"out{D}.npz")
    np.savez(inp, **x)
    spawn_ranks([sys.executable, "-c", WORKER, str(D), inp, outp], D,
                timeout=240)
    return dict(np.load(outp))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{D: (inputs, messages, JAX results, port results)}: the port's rank
    groups run while the JAX side computes here, its compiles in
    threads (XLA compiles with the interpreter lock released)."""
    tmp = str(tmp_path_factory.mktemp("stream_ranks"))
    inputs = {D: _inputs(D) for D in DS}
    with ThreadPoolExecutor(len(DS)) as ranks, ThreadPoolExecutor(6) as jax:
        port = {D: ranks.submit(_port_results, D, inputs[D][0], tmp)
                for D in DS}
        futs = {D: {k: jax.submit(lambda f=f: np.asarray(f()))
                    for k, f in _jax_jobs(D, inputs[D][0]).items()}
                for D in DS}
        return {D: (*inputs[D], {k: f.result() for k, f in futs[D].items()},
                    port[D].result()) for D in DS}


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("case", ["vit_k3", "vit_k7"])
def test_viterbi_stream_bits_equal_jax(runs, D, case):
    x, msgs, jout, pout = runs[D]
    np.testing.assert_array_equal(pout[case], jout[case])
    tb = 15 if case == "vit_k3" else 30
    tr = Trellis(*map(np.array, K3 if case == "vit_k3" else K7))
    serial = viterbi_decode_device(x[case], tr, tb, "soft",
                                   L=msgs[case].size, device=CPU).numpy()
    assert (pout[case] != serial).mean() < 1e-3
    if case == "vit_k3":
        assert (pout[case] != msgs[case]).mean() < 0.02
    else:
        np.testing.assert_array_equal(pout[case], msgs[case])


@pytest.mark.parametrize("D", DS)
def test_viterbi_stream_warmup_zero_is_an_empty_halo(runs, D):
    """The JAX stream at warmup_codewords=0 takes the whole shard as its
    halo and decodes noise (BER ~ 0.5); the port's halo is empty, so it
    errs only near the shard boundaries, where each shard starts cold."""
    x, msgs, jout, pout = runs[D]
    msg = msgs["vit_k7"]
    assert (jout["vit_k7_w0"] != msg).mean() > 0.3
    serial = viterbi_decode_device(x["vit_k7"], Trellis(*map(np.array, K7)),
                                   30, "soft", L=msg.size,
                                   device=CPU).numpy()
    np.testing.assert_array_equal(serial, msg)
    off = np.flatnonzero(pout["vit_k7_w0"] != serial)
    # every disagreement lies within a few constraint lengths after the
    # start of a shard other than the first
    assert off.size < 16 * (D - 1)
    assert all(0 < o // 512 and o % 512 < 60 for o in off), off


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("case", ["turbo_warmup", "turbo_nii", "turbo_w0"])
def test_turbo_stream_decisions_equal_jax(runs, D, case):
    x, msgs, jout, pout = runs[D]
    np.testing.assert_array_equal(pout[case], jout[case])
    np.testing.assert_array_equal(pout[case], msgs[case])
    if case != "turbo_w0":
        y = x[case]
        serial = PT.turbo_decode_device(
            y[0], y[1], y[2], Trellis(*map(np.array, RSC[:2]), *RSC[2:]),
            float(x[case + "_nv"]), 3, x[case + "_p"], backend="torch",
            device=CPU).numpy()
        assert (serial != pout[case]).mean() < 1e-3


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("case", ["turbo_warmup", "turbo_nii"])
def test_turbo_stream_kernel_route_decides_as_bcjr_masked(runs, D, case):
    # backend='auto' runs each MAP pass through K3's wrapper (its plain
    # version on these CPU tensors): [T, R] streams pre-scaled by 1/nv,
    # carries renormalised; its decisions are the backend='torch' route's
    # (_bcjr_masked)
    pout = runs[D][3]
    np.testing.assert_array_equal(pout[case], pout[case + "_torch"])


@pytest.mark.parametrize("T", [288, 1152, 4608, 6144])
@pytest.mark.parametrize("mode", ["valid", "boundary"])
def test_kernel_route_app_values_match_bcjr_masked(T, mode):
    """One MAP pass of T steps through K3's route (its plain version
    here) and through _bcjr_masked, on the same inputs.  Unrenormalised,
    K3's metrics would grow along the window by up to Gamma = sum over
    the valid steps of (|sy| + |pa|) / nv + |li|, and e, a difference of
    two such sums, would carry float32 rounding of about eps * Gamma;
    the route renormalises every STREAM_RENORM_EVERY steps, so e and the
    carries (up to their constant offset) stay within 1e-5 (1 + |want|)
    at every T, and within 4 eps Gamma as well; a halo or carry fault
    would be off by O(1)."""
    from commpy_tpu_torch.ops.interleave import RandInterlv
    from commpy_tpu_torch.ops.stream import _map_pass

    tr = Trellis(*map(np.array, RSC[:2]), *RSC[2:])
    rng = np.random.RandomState(T)
    p = RandInterlv(T, 0).p_array
    msg = torch.as_tensor(rng.randint(0, 2, (1, T)).astype(np.int8))
    x = 2.0 * torch.stack(PT.turbo_encode_device(msg, tr, tr, p, device=CPU)
                          ).float()[:, 0] - 1
    nv = np.float32(0.5)
    inv = float(np.float32(1) / nv)
    y = x + torch.as_tensor(rng.randn(3, T).astype(np.float32)) * float(
        np.sqrt(nv))
    li = torch.as_tensor(rng.randn(T).astype(np.float32) * 4)
    if mode == "valid":  # a middle shard: no exact start, dead halos
        W = 64
        valid = torch.ones(T, dtype=torch.bool)
        valid[:W] = valid[T - W:] = False
        kw = {"valid": valid}
        first = torch.tensor([False])
    else:
        valid = torch.ones(T, dtype=torch.bool)
        a0 = torch.as_tensor(rng.randn(4).astype(np.float32) * 2)
        bT = torch.as_tensor(rng.randn(4).astype(np.float32) * 2)
        kw = {"boundary": (a0 - a0.max(), bT - bT.max())}
        first = torch.tensor([True])
    args = (y[0], y[1], li, nv, inv, tr, False, first)
    got = _map_pass("kernel", *args, **kw)
    want = _map_pass("torch", *args, **kw)
    if mode == "valid":
        got, want = (got,), (want,)
    gamma = float((((y[0].abs() + y[1].abs()) * inv + li.abs())[valid]).sum())
    bound = 4 * float(np.finfo(np.float32).eps) * gamma
    dev_e = (got[0] - want[0]).abs()
    tol = 1e-5 * (1 + want[0].abs())
    assert float(dev_e.max()) <= bound, (float(dev_e.max()), bound)
    assert bool((dev_e <= tol).all()), float((dev_e / tol).max())
    flips = (got[0] > 0) != (want[0] > 0)
    assert flips[want[0].abs() > bound].sum() == 0
    assert flips[want[0].abs() > tol].sum() == 0
    for g, w in zip(got[1:], want[1:]):
        dg = ((g - g.max()) - (w - w.max())).abs()
        assert float(dg.max()) <= bound
        assert bool((dg <= 1e-5 * (1 + (w - w.max()).abs())).all())


@pytest.mark.parametrize("D", DS)
def test_sharded_fir_matches_jax_and_full_convolution(runs, D):
    x, _, jout, pout = runs[D]
    np.testing.assert_allclose(pout["fir"], jout["fir"], rtol=1e-5,
                               atol=1e-5)
    n = x["fir_x"].size
    full = PF.fir_filter(x["fir_x"], x["fir_taps"], "full",
                         device=CPU).numpy()[:n]
    np.testing.assert_allclose(pout["fir"], full, rtol=1e-5, atol=1e-5)


def test_world_one_stream_defaults_and_guards():
    """On one rank: tb_depth 0 means 5 * total_memory (not the serial
    decoder's min(5 * memory, L)), the halos are zeros, and halos longer
    than the shard or a mesh named for another axis are refused."""
    from commpy_tpu_torch.ops.stream import sharded_viterbi_stream
    from commpy_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, "sp", device=CPU)
    tr = Trellis(*map(np.array, K7))
    rng = np.random.RandomState(3)
    llr = torch.as_tensor(rng.randn(2 * 400).astype(np.float32) * 3)
    got = sharded_viterbi_stream(llr, tr, mesh, warmup_codewords=16)
    R = 5 * tr.total_memory
    ext = torch.cat([torch.zeros(2 * 16), llr, torch.zeros(2 * R)])
    want = viterbi_decode_device(ext, tr, R, "soft", L=16 + 400 + R,
                                 device=CPU)[16:16 + 400]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="exceed"):
        sharded_viterbi_stream(llr, tr, mesh, warmup_codewords=401)
    with pytest.raises(ValueError, match="dimension"):
        sharded_viterbi_stream(llr, tr, make_mesh(1, "dp", device=CPU))
