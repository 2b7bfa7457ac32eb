"""The port's mesh, data-parallel Monte-Carlo engine, tensor-parallel
decoders and pipeline against the JAX package's, on D = 1, 2 and 4 ranks.

The JAX functions run here on ``commpy_tpu.parallel.make_mesh(D)`` over
the virtual CPU devices; the port's run in D gloo rank processes
(``commpy_tpu_torch.parallel.dryrun.spawn_ranks``, a ``file://`` store)
that import neither ``jax`` nor ``commpy_tpu``: one group a D runs every
case and rank 0 hands the results back as ``.npz`` (each rank checks
that its own results equal rank 0's where they must be replicated).

Held: ``ldpc_bp_decode_sharded`` (Gallager 96.33.964, MSA and SPA, and
the same code less its last check, whose 47 rows are padded to a
multiple of D): decisions equal, posteriors within 1e-5 relative; ``qc_bp_decode_sharded``
(``random_qc_params(6, 12, 16)``, the JAX test's LLRs): MSA bit for bit,
SPA within 1e-4 on sub-saturation LLRs, and the ``Z % n_devices`` error;
``pipeline_map`` on the three cases of ``test_pipeline.py`` (stage lists
cut or composed to D stages): equal, int dtype kept.  A round with a
mesh of D ranks equals the round without one for the same seed, exactly
(uncoded QPSK and the K=7 conv link); ``montecarlo_ber`` over a mesh
meets erfc within rtol 0.25; ``link_performance_device(mesh=...)`` gives
``mesh=None``'s BERs; a checkpointed sweep over a mesh resumes to the
straight sweep's tallies.  Each link factory's ``link_step`` is what it
was before ``draw`` was split out of it, on a fixed seed (the error
counts recorded from the earlier code), and its row shards add up to the
whole.  ``dryrun_multichip(2, device="cpu")`` passes.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commpy_tpu.ops import ldpc as JL
from commpy_tpu.ops import qcldpc as JQ
from commpy_tpu.parallel import make_mesh as j_make_mesh
from commpy_tpu.parallel.pipeline import pipeline_map as j_pipeline_map

import commpy_tpu_torch.parallel as par
from commpy_tpu_torch.models import device_links as DL
from commpy_tpu_torch.ops import bch as PB
from commpy_tpu_torch.ops import dvbs2 as PD
from commpy_tpu_torch.ops import ldpc as PL
from commpy_tpu_torch.ops import polar as PP
from commpy_tpu_torch.ops import qcldpc as PQ
from commpy_tpu_torch.ops import rs as PR
from commpy_tpu_torch.ops.interleave import RandInterlv
from commpy_tpu_torch.ops.trellis import Trellis
from commpy_tpu_torch.parallel.dryrun import dryrun_multichip, spawn_ranks

torch.set_num_threads(1)

CPU = "cpu"
DS = (2, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GALLAGER = os.path.join(REPO, "commpy_tpu", "designs", "ldpc", "gallager",
                        "96.33.964.txt")
SCALARS = (1.0, 0.5, 2.0, -1.0)

WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
D, inp, outp, ckpt, uneven = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4], sys.argv[5])
rank = int(sys.argv[sys.argv.index("--rank") + 1])
init = sys.argv[sys.argv.index("--init") + 1]
from commpy_tpu_torch.links import LinkModel
from commpy_tpu_torch.channels import SISOFlatChannel
from commpy_tpu_torch.models import make_conv_awgn_link
from commpy_tpu_torch.ops import modem as M
from commpy_tpu_torch.ops.channel import snr_to_noise_std
from commpy_tpu_torch.ops.ldpc import (DESIGNS, get_ldpc_code_params,
                                       ldpc_bp_decode_sharded)
from commpy_tpu_torch.ops.qcldpc import qc_bp_decode_sharded, random_qc_params
from commpy_tpu_torch.ops.trellis import Trellis
from commpy_tpu_torch.parallel import (distributed, make_mesh,
                                       make_round_fn, montecarlo_ber,
                                       pipeline_map)

distributed.initialize(init, D, rank, device="cpu")
mesh = make_mesh(D, "dp", device="cpu")
x = {k: torch.as_tensor(v) for k, v in np.load(inp).items()}
qc = random_qc_params(6, 12, 16, col_weight=3, seed=3)
res = {"process_info": np.asarray(distributed.process_info())}

gallager = get_ldpc_code_params(DESIGNS + "/gallager/96.33.964.txt")
odd = get_ldpc_code_params(uneven)  # 47 checks: padded at D = 2 and 4
for alg in ("MSA", "SPA"):
    d, o = ldpc_bp_decode_sharded(x["ldpc_llr"], gallager, alg, 5, mesh)
    res[f"ldpc_{alg}_dec"], res[f"ldpc_{alg}_llr"] = d, o
    d, o = ldpc_bp_decode_sharded(x["ldpc_llr"], odd, alg, 5, mesh)
    res[f"ldpc47_{alg}_dec"], res[f"ldpc47_{alg}_llr"] = d, o
    d, o = qc_bp_decode_sharded(x[f"qc_{alg}_llr"], qc, alg, 8, mesh)
    res[f"qc_{alg}_dec"], res[f"qc_{alg}_llr"] = d, o
try:
    qc_bp_decode_sharded(x["qc_MSA_llr"], dict(qc, Z=9), "MSA", 2, mesh)
except ValueError as e:
    res["qc_z_error"] = np.asarray(str(e))

# pipeline: D of the scalar stages; the link stages composed to D; +1 ints
scalars = [float(a) for a in x["scalars"][:D]]
res["pipe_scalar"] = pipeline_map(
    [lambda w, a=a: w * a + a for a in scalars], x["pipe_mb"], mesh)


def tx(w):
    return torch.stack([2.0 * w[1] - 1.0, w[1]])


def chan(w):
    return torch.stack([w[0] * 0.9, w[1]])


def demap(w):
    return torch.stack([2.0 * w[0] / 0.5, w[1]])


def slic(w):
    return torch.stack([(w[0] > 0).to(w.dtype), w[1]])


ops = [tx, chan, demap, slic]
per = len(ops) // D
stages = [lambda w, fs=ops[i * per:(i + 1) * per]: _compose(fs, w)
          for i in range(D)]


def _compose(fs, w):
    for f in fs:
        w = f(w)
    return w


res["pipe_link"] = pipeline_map(stages, x["pipe_wire"], mesh)
res["pipe_int"] = pipeline_map([lambda w: w + 1] * D, x["pipe_ints"], mesh)

# data parallel: a round with the mesh and without
qpsk = M.qam_constellation(4).astype(np.complex64)


def qpsk_step(gen, frames, noise_std, rows=None):
    bits = torch.randint(0, 2, (frames, 200), generator=gen,
                         dtype=torch.int8)
    z = torch.randn((2, frames, 100), generator=gen)
    if rows is not None:
        bits, z = bits[rows], z[:, rows]
    y = M.modulate(bits, qpsk, 2, device="cpu") + torch.complex(
        z[0], z[1]) * (noise_std * 0.5)
    return torch.sum(M.demodulate_hard(y, qpsk, 2) ^ bits,
                     dtype=torch.int32)


conv = make_conv_awgn_link(
    trellis=Trellis(np.array([6]), np.array([[0o133, 0o171]])),
    frame_bits=200, device="cpu")
nsf = lambda s: snr_to_noise_std(s, Es=2.0)  # noqa: E731
for name, step, stds in (
        ("qpsk", qpsk_step, [float(nsf(s)) for s in (0.0, 4.0)]),
        ("conv", conv.link_step,
         [float(conv.noise_std_fn(s)) for s in (0.0, 2.0)])):
    for seed, rnd in ((7, 0), (7, 3)):
        key = f"round_{name}_{rnd}"
        res[key + "_mesh"] = make_round_fn(step, stds, 16, "cpu", mesh)(
            seed, rnd)
        res[key + "_solo"] = make_round_fn(step, stds, 16, "cpu")(seed, rnd)
try:
    make_round_fn(qpsk_step, [1.0], D + 1, "cpu", mesh)
except ValueError as e:
    res["fpr_error"] = np.asarray(str(e))
snrs = np.arange(0, 9, 2.0)
mc = montecarlo_ber(qpsk_step, snrs, nsf, 200, seed=42, frames_per_round=64,
                    max_rounds=40, err_min=300, send_max=500_000,
                    device="cpu", mesh=mesh)
res["mc_bers"], res["mc_rounds"] = mc.bers, np.asarray(mc.rounds)
solo = montecarlo_ber(qpsk_step, snrs, nsf, 200, seed=42, frames_per_round=64,
                      max_rounds=40, err_min=300, send_max=500_000,
                      device="cpu")
res["mc_sweeps"] = np.stack([
    np.r_[m.bit_errors, m.bits_sent, m.rounds] for m in (mc, solo)])
kw = dict(snrs_db=[2.0, 6.0], noise_std_fn=nsf, frame_bits=200, seed=11,
          frames_per_round=8, err_min=10 ** 9, device="cpu", mesh=mesh)
straight = montecarlo_ber(qpsk_step, max_rounds=4, **kw)
first = montecarlo_ber(qpsk_step, max_rounds=2, checkpoint_path=ckpt, **kw)
resumed = montecarlo_ber(qpsk_step, max_rounds=4, checkpoint_path=ckpt, **kw)
res["ckpt"] = np.stack([straight.bit_errors, first.bit_errors,
                        resumed.bit_errors, [straight.rounds, resumed.rounds]])

model = LinkModel(lambda b: M.modulate(b, qpsk, 2, device="cpu"),
                  SISOFlatChannel(fading_param=(1 + 0j, 0), device="cpu"),
                  lambda y, h, c, nv: M.demodulate_hard(y, qpsk, 2), 2,
                  qpsk, 2.0, device="cpu")
res["lpd_mesh"] = model.link_performance_device(
    [0.0, 4.0], 16_000, 10 ** 6, 1000, frames_per_round=4, mesh=mesh)
res["lpd_solo"] = model.link_performance_device(
    [0.0, 4.0], 16_000, 10 ** 6, 1000, frames_per_round=4)

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "commpy_tpu"))
if bad:
    raise SystemExit(f"a rank imported {bad}")
out = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
       for k, v in res.items()}
# what is replicated must be the same on every rank
for k in ("ldpc_MSA_dec", "ldpc_SPA_llr", "ldpc47_SPA_llr", "qc_MSA_llr",
          "pipe_link", "round_conv_3_mesh", "mc_bers", "mc_sweeps",
          "lpd_mesh"):
    g = [torch.empty_like(torch.as_tensor(out[k])) for _ in range(D)]
    dist.all_gather(g, torch.as_tensor(out[k]))
    if any(not torch.equal(g[0], t) for t in g):
        raise SystemExit(f"{k} differs between ranks")
if rank == 0:
    np.savez(outp, **out)
dist.barrier()
dist.destroy_process_group()
'''


def _qc_llr(params, alg, seed=0):
    """The JAX test's MSA LLRs (``tests/test_qcldpc.py``); sub-saturation
    LLRs for SPA, as ``test_torch_qcldpc.py`` makes them."""
    rng = np.random.RandomState(seed)
    if alg == "SPA":
        return (rng.randn(4, params["n_vnodes"]) * 1.5 + 0.5).astype(
            np.float32)
    msg = rng.randint(0, 2, (4, params["k_bits"])).astype(np.int8)
    cw = np.asarray(JQ.qc_encode_device(msg, params))
    return (2.0 * ((1.0 - 2.0 * cw) + 0.6 * rng.randn(*cw.shape))
            / 0.36).astype(np.float32)


def _inputs():
    rng = np.random.RandomState(5)
    qc = JQ.random_qc_params(6, 12, 16, col_weight=3, seed=3)
    bits = rng.randint(0, 2, (6, 64)).astype(np.float32)
    return {
        "ldpc_llr": (rng.randn(4, 96) * 2).astype(np.float32),
        "qc_MSA_llr": _qc_llr(qc, "MSA"),
        "qc_SPA_llr": _qc_llr(qc, "SPA", 1),
        "scalars": np.asarray(SCALARS, np.float32),
        "pipe_mb": rng.randn(5, 4, 16).astype(np.float32),
        "pipe_wire": np.stack([np.zeros_like(bits), bits], axis=1),
        "pipe_ints": np.arange(3 * 2 * 16, dtype=np.int32).reshape(3, 2, 16),
    }


def _uneven_design(tmp):
    """Gallager 96.33.964 without its last check: 47 check rows, which
    divide by neither 2 nor 4 ranks, as a design file."""
    path = os.path.join(tmp, "gallager_96_47.txt")
    params = JL.get_ldpc_code_params(GALLAGER)
    H = np.zeros((params["n_cnodes"], params["n_vnodes"]), np.int8)
    adj = params["cnode_adj_list"].reshape(params["n_cnodes"], -1)
    for c, deg in enumerate(params["cnode_deg_list"]):
        H[c, adj[c, :deg]] = 1
    JL.write_ldpc_params(H[:-1], path)
    return path


def _jax_jobs(D, x, uneven):
    mesh = j_make_mesh(D, "dp")
    params = JL.get_ldpc_code_params(GALLAGER)
    odd = JL.get_ldpc_code_params(uneven)
    qc = JQ.random_qc_params(6, 12, 16, col_weight=3, seed=3)
    jobs = {}
    for alg in ("MSA", "SPA"):
        jobs[f"ldpc_{alg}"] = (lambda alg=alg: JL.ldpc_bp_decode_sharded(
            x["ldpc_llr"], params, alg, 5, mesh))
        jobs[f"ldpc47_{alg}"] = (lambda alg=alg: JL.ldpc_bp_decode_sharded(
            x["ldpc_llr"], odd, alg, 5, mesh))
        jobs[f"qc_{alg}"] = (lambda alg=alg: JQ.qc_bp_decode_sharded(
            x[f"qc_{alg}_llr"], qc, alg, 8, mesh))
    jobs["pipe_scalar"] = lambda: j_pipeline_map(
        [lambda w, a=a: w * a + a for a in SCALARS[:D]],
        jnp.asarray(x["pipe_mb"]), mesh)
    jobs["pipe_int"] = lambda: j_pipeline_map(
        [lambda w: w + 1] * D, jnp.asarray(x["pipe_ints"]), mesh)

    def z_error():
        try:
            JQ.qc_bp_decode_sharded(x["qc_MSA_llr"], dict(qc, Z=9), "MSA", 2,
                                    mesh)
        except ValueError as e:
            return str(e)
    jobs["qc_z_error"] = z_error
    return jobs


def _port_results(D, x, tmp, uneven):
    inp = os.path.join(tmp, f"in{D}.npz")
    outp = os.path.join(tmp, f"out{D}.npz")
    np.savez(inp, **x)
    spawn_ranks([sys.executable, "-c", WORKER, str(D), inp, outp,
                 os.path.join(tmp, f"ckpt{D}.json"), uneven], D, timeout=240)
    return dict(np.load(outp))


def _value(r):
    return (tuple(np.asarray(v) for v in r) if isinstance(r, tuple)
            else r if isinstance(r, str) else np.asarray(r))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{D: (JAX results, port results)}: the port's rank groups run while
    the JAX side compiles here, in threads."""
    tmp = str(tmp_path_factory.mktemp("parallel_ranks"))
    x = _inputs()
    uneven = _uneven_design(tmp)
    with ThreadPoolExecutor(len(DS)) as ranks, ThreadPoolExecutor(4) as jax:
        port = {D: ranks.submit(_port_results, D, x, tmp, uneven)
                for D in DS}
        futs = {D: {k: jax.submit(lambda f=f: _value(f()))
                    for k, f in _jax_jobs(D, x, uneven).items()}
                for D in DS}
        return x, {D: ({k: f.result() for k, f in futs[D].items()},
                       port[D].result()) for D in DS}


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("alg", ["MSA", "SPA"])
def test_ldpc_sharded_matches_jax(runs, D, alg):
    jout, pout = runs[1][D]
    jd, jo = jout[f"ldpc_{alg}"]
    np.testing.assert_array_equal(pout[f"ldpc_{alg}_dec"], jd)
    np.testing.assert_allclose(pout[f"ldpc_{alg}_llr"], jo, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("alg", ["MSA", "SPA"])
def test_ldpc_sharded_pads_uneven_check_rows_as_jax(runs, D, alg):
    # 47 check rows: the last rank's share is padded with masked rows
    jout, pout = runs[1][D]
    jd, jo = jout[f"ldpc47_{alg}"]
    np.testing.assert_array_equal(pout[f"ldpc47_{alg}_dec"], jd)
    np.testing.assert_allclose(pout[f"ldpc47_{alg}_llr"], jo, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("alg", ["MSA", "SPA"])
def test_qc_sharded_matches_jax(runs, D, alg):
    jout, pout = runs[1][D]
    jd, jo = jout[f"qc_{alg}"]
    np.testing.assert_array_equal(pout[f"qc_{alg}_dec"], jd)
    if alg == "MSA":
        np.testing.assert_array_equal(pout[f"qc_{alg}_llr"], jo)
    else:
        np.testing.assert_allclose(pout[f"qc_{alg}_llr"], jo, rtol=1e-4,
                                   atol=1e-4)


def test_ranks_build_the_jax_packages_qc_code():
    j = JQ.random_qc_params(6, 12, 16, col_weight=3, seed=3)
    p = PQ.random_qc_params(6, 12, 16, col_weight=3, seed=3)
    for key in ("block_j", "block_s", "Z", "Mb", "Nb", "K"):
        np.testing.assert_array_equal(np.asarray(p[key]), np.asarray(j[key]))


@pytest.mark.parametrize("D", DS)
def test_qc_sharded_z_error(runs, D):
    jout, pout = runs[1][D]
    assert "Z % n_devices" in jout["qc_z_error"]
    assert str(pout["qc_z_error"]) == jout["qc_z_error"]


@pytest.mark.parametrize("D", DS)
def test_pipeline_matches_jax_and_serial(runs, D):
    x, (jout, pout) = runs[0], runs[1][D]
    np.testing.assert_allclose(pout["pipe_scalar"], jout["pipe_scalar"],
                               rtol=1e-6)
    expect = x["pipe_mb"]
    for a in SCALARS[:D]:
        expect = expect * np.float32(a) + np.float32(a)
    np.testing.assert_allclose(pout["pipe_scalar"], expect, rtol=1e-6)
    bits = x["pipe_wire"][:, 1]
    np.testing.assert_array_equal(pout["pipe_link"][:, 0], bits)
    np.testing.assert_array_equal(pout["pipe_link"][:, 1], bits)
    assert pout["pipe_int"].dtype == np.int32
    np.testing.assert_array_equal(pout["pipe_int"], jout["pipe_int"])
    np.testing.assert_array_equal(pout["pipe_int"], x["pipe_ints"] + D)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("link", ["qpsk", "conv"])
def test_mesh_round_equals_single_device_round(runs, D, link):
    pout = runs[1][D][1]
    for rnd in (0, 3):
        np.testing.assert_array_equal(pout[f"round_{link}_{rnd}_mesh"],
                                      pout[f"round_{link}_{rnd}_solo"])
    assert pout[f"round_{link}_0_mesh"].sum() > 0


@pytest.mark.parametrize("D", DS)
def test_mesh_montecarlo_meets_theory(runs, D):
    from scipy.special import erfc

    pout = runs[1][D][1]
    snrs = np.arange(0, 9, 2.0)
    np.testing.assert_allclose(pout["mc_bers"],
                               erfc(np.sqrt(10 ** (snrs / 10) / 2)) / 2,
                               rtol=0.25)
    assert "multiple of the mesh size" in str(pout["fpr_error"])


@pytest.mark.parametrize("D", DS)
def test_mesh_sweep_equals_single_device_sweep(runs, D):
    # the points stop at different rounds; the ranks skip the same ones
    mesh, solo = runs[1][D][1]["mc_sweeps"]
    np.testing.assert_array_equal(mesh, solo)
    errs, sent, rounds = mesh[:5], mesh[5:10], mesh[10]
    assert (errs[:3] >= 300).all() and len(set(sent)) > 1 and rounds > 1


@pytest.mark.parametrize("D", DS)
def test_mesh_checkpoint_resume_and_process_info(runs, D):
    pout = runs[1][D][1]
    straight, first, resumed, rounds = pout["ckpt"]
    np.testing.assert_array_equal(resumed, straight)
    assert (first < straight).all() and tuple(rounds) == (4, 4)
    np.testing.assert_array_equal(pout["process_info"], [0, D, 0, D])


@pytest.mark.parametrize("D", DS)
def test_link_performance_device_over_a_mesh(runs, D):
    pout = runs[1][D][1]
    np.testing.assert_array_equal(pout["lpd_mesh"], pout["lpd_solo"])
    assert 0 < pout["lpd_mesh"][1] < pout["lpd_mesh"][0]


# ------------------------------------------- one rank, in this process

def test_world_one_mesh_rounds_and_guards():
    mesh = par.make_mesh(1, device=CPU)
    assert par.make_mesh(device=CPU).size() == 1
    link = DL.make_conv_awgn_link(
        trellis=Trellis(np.array([6]), np.array([[0o133, 0o171]])),
        frame_bits=200, device=CPU)
    stds = [float(link.noise_std_fn(s)) for s in (0.0, 2.0)]
    a = par.make_round_fn(link.link_step, stds, 8, CPU, mesh)(3, 1)
    b = par.make_round_fn(link.link_step, stds, 8, CPU)(3, 1)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError, match="rows"):
        par.make_round_fn(lambda g, f, ns: None, stds, 8, CPU, mesh)(0, 0)
    with pytest.raises(ValueError, match="needs as many ranks"):
        par.make_mesh(2, device=CPU)
    with pytest.raises(ValueError, match="dimension"):
        par.make_round_fn(link.link_step, stds, 8, CPU, mesh, "sp")
    assert par.distributed.is_initialized()
    assert par.distributed.process_info()[:2] == (0, 1)
    assert par.local_device_count() == torch.cuda.device_count()


def test_make_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.make_mesh()


def test_dryrun_multichip_on_two_cpu_ranks():
    dryrun_multichip(2, device=CPU, timeout=240)


# --------------------------------------- the draw split of the factories

K7 = Trellis(np.array([6]), np.array([[0o133, 0o171]]))
RSC = Trellis(np.array([2]), np.array([[1, 7]]), 5, "rsc")


def _wimax960():
    return PL.get_ldpc_code_params(os.path.join(PL.DESIGNS, "wimax",
                                                "960.720.a.txt"), True)


# factory, frames, SNR (dB), errors of link_step(seed 5) before the split
FACTORIES = {
    "conv": (lambda: DL.make_conv_awgn_link(
        trellis=K7, modulation_m=16, use_psk=False, frame_bits=240,
        device=CPU), 4, 9.0, 33),
    "rrc_conv": (lambda: DL.make_rrc_conv_awgn_link(
        trellis=K7, frame_bits=240, device=CPU), 4, 6.0, 377),
    "turbo": (lambda: DL.make_turbo_awgn_link(
        trellis=RSC, frame_bits=128, p_array=RandInterlv(128, 0).p_array,
        n_iterations=2, device=CPU), 4, 0.0, 112),
    "qcldpc": (lambda: DL.make_qcldpc_awgn_link(
        qc_params=PQ.ieee80211n_params(648, "1/2"), device=CPU), 4, 2.0,
        308),
    "ofdm_qcldpc": (lambda: DL.make_ofdm_qcldpc_link(
        qc_params=PQ.ieee80211n_params(648, "1/2"), csi="ls", device=CPU),
        4, 6.0, 293),
    "dvbs2_concat": (lambda: DL.make_dvbs2_concat_link(
        qc_params=PD.dvbs2_qc_params(PD.synthetic_address_table(
            16200, "1/2", seed=0), 16200, "1/2"), n_iterations=5,
        device=CPU), 2, 0.5, 3924),
    "isi_conv": (lambda: DL.make_isi_conv_link(
        trellis=K7, channel_taps=np.array([0.407, 0.815, 0.407]),
        frame_bits=200, device=CPU), 4, 4.0, 367),
    "bch": (lambda: DL.make_bch_awgn_link(
        code=PB.bch_construct(5, 2), decoder="chase", device=CPU), 16, 2.0,
        9),
    "rs": (lambda: DL.make_rs_awgn_link(
        code=PR.rs_construct(4, 2, fcr=0), decoder="gmd", device=CPU), 8,
        4.0, 97),
    "ldpc_rayleigh": (lambda: DL.make_ldpc_rayleigh_link(
        ldpc_params=_wimax960(), n_iterations=5, device=CPU), 2, 8.0, 92),
    "kbest_mimo": (lambda: DL.make_kbest_mimo_link(
        vectors_per_frame=8, device=CPU), 4, 12.0, 60),
    "bestfirst_ldpc_mimo": (lambda: DL.make_bestfirst_ldpc_mimo_link(
        ldpc_params=_wimax960(), beam=8, n_iterations=5, device=CPU), 2,
        16.0, 91),
    "ofdm_mimo_conv": (lambda: DL.make_ofdm_mimo_conv_link(
        trellis=K7, n_ofdm_symbols=2, device=CPU), 4, 10.0, 167),
    "polar": (lambda: DL.make_polar_awgn_link(
        code=PP.polar_construct(128, 64, design_snr_db=2.0), list_size=2,
        device=CPU), 8, -2.0, 207),
    "idd": (lambda: DL.make_idd_kbest_ldpc_mimo_link(
        ldpc_params=_wimax960(), beam=4, n_iterations=5, device=CPU), 2,
        16.0, 235),
}


def test_every_factory_is_covered():
    made = {name for name in DL.__all__ if name.startswith("make_")}
    assert len(made) == len(FACTORIES) == 15


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_link_step_unchanged_by_the_draw_split(name):
    make, frames, snr, before = FACTORIES[name]
    link = make()
    ns = float(link.noise_std_fn(snr))
    gen = torch.Generator()
    gen.manual_seed(5)
    assert int(link.link_step(gen, frames, ns)) == before
    # the draw is the link_step's: its transceive on it counts the same
    gen.manual_seed(5)
    bits, noise, *channel = link.draw(gen, frames)
    dec = link.transceive(bits, noise, ns, *channel)
    assert int((dec != bits).sum()) == before
    # and two row shards of the round add up to it
    halves = []
    for rows in (slice(0, frames // 2), slice(frames // 2, frames)):
        gen.manual_seed(5)
        halves.append(int(link.link_step(gen, frames, ns, rows=rows)))
    assert sum(halves) == before
