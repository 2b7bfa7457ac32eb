"""The port's tracing: gated spans, the engine's and the draws' spans,
and K4's sweep counter.

``utils.profiling.span`` is a ``record_function`` while a profiler
records and a shared no-op otherwise; ``recording()`` reads a private
torch flag, which these tests pin.  ``qc_bp_resident`` counts the sweeps
and frames it decodes while a profiler records; on the CPU its plain
version counts, held here to a count made from the code's checks
directly.  The card tests (marked ``card``, skipping without one) hold
K4's count to the plain version's, and K6, the joint demapper, to its
plain version bit for bit with its launch counter rising by one a call;
this file imports no JAX, so on the card it runs as ``python -m pytest
tests/test_torch_tracing.py --noconftest -m card``.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from commpy_tpu_torch.kernels import demap as D
from commpy_tpu_torch.kernels import qc_bp as K
from commpy_tpu_torch.models.device_links import make_qcldpc_awgn_link
from commpy_tpu_torch.ops import modem as PM
from commpy_tpu_torch.ops import qcldpc as PQ
from commpy_tpu_torch.parallel.montecarlo import montecarlo_ber
from commpy_tpu_torch.utils import profiling

N_ITERS = 15


@pytest.fixture
def counters():
    """K4's counters at 0 before and after the test."""
    K.qc_bp_resident.sweeps = K.qc_bp_resident.frames = 0
    yield K.qc_bp_resident
    K.qc_bp_resident.sweeps = K.qc_bp_resident.frames = 0


def _annotations(prof, tmp_path):
    """``[(name, start, end)]`` of the trace's user annotations, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                  key=lambda s: s[1])


def _inside(spans, outer, name):
    return [s for s in spans if s[0] == name
            and outer[1] <= s[1] and s[2] <= outer[2]]


def test_span_is_a_shared_noop_without_a_profiler():
    assert not profiling.recording()
    a, b = profiling.span("link.x"), profiling.span("mc.y")
    assert a is b
    with a:
        pass


def test_span_records_a_user_annotation_under_the_profiler(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with profiling.span("tracing.pinned"):
            torch.ones(8).sum()
    assert not profiling.recording()
    names = [s[0] for s in _annotations(prof, tmp_path)]
    assert names.count("tracing.pinned") == 1


def test_montecarlo_sweep_spans(tmp_path):
    """One sweep at 0 dB (stops after its first round) and 12 dB (runs to
    ``max_rounds``): round 0 simulates both points, rounds 1-2 only the
    12 dB point, and every round has one ``mc.seed`` and one ``mc.tally``."""
    link = make_qcldpc_awgn_link(qc_params=PQ.ieee80211n_params(648, "1/2"),
                                 modulation_m=4, n_iterations=5,
                                 device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = montecarlo_ber(link.link_step, [0.0, 12.0], link.noise_std_fn,
                             link.frame_bits, 2**31 + 5, frames_per_round=2,
                             max_rounds=3, err_min=1, device="cpu")
    assert res.rounds == 3 and res.bits_sent[0] < res.bits_sent[1]
    spans = _annotations(prof, tmp_path)
    sweeps = [s for s in spans if s[0] == "mc.sweep"]
    rounds = [s for s in spans if s[0] == "mc.round"]
    assert len(sweeps) == 1 and len(rounds) == res.rounds
    for r, points in zip(rounds, (2, 1, 1)):
        assert _inside(spans, sweeps[0], "mc.round").count(r) == 1
        assert len(_inside(spans, r, "mc.seed")) == 1
        assert len(_inside(spans, r, "mc.tally")) == 1
        assert len(_inside(spans, r, "link.draw")) == points
        assert len(_inside(spans, r, "link.encode")) == points
    assert len([s for s in spans if s[0] == "link.draw"]) == 4
    order = [s[0] for s in spans if s[0] in ("link.draw", "link.encode")]
    assert order == ["link.draw", "link.encode"] * 4
    draws = [s for s in spans if s[0] == "link.draw"]
    encodes = [s for s in spans if s[0] == "link.encode"]
    assert all(d[2] <= e[1] for d, e in zip(draws, encodes))


def _llrs(seed, n_clean):
    """802.11n (648, 1/2) LLRs of BPSK codewords: ``n_clean`` noiseless
    frames, then six noisy ones that converge at different sweeps or not
    at all."""
    p = PQ.ieee80211n_params(648, "1/2")
    rng = np.random.RandomState(seed)
    B = n_clean + 6
    msg = rng.randint(0, 2, (B, p["k_bits"])).astype(np.int8)
    cw = PQ.qc_encode_device(msg, p, device="cpu").numpy()
    sigma = np.r_[np.zeros(n_clean), [0.6, 0.7, 0.8, 0.85, 0.9, 1.1]]
    y = (1.0 - 2.0 * cw) + sigma[:, None] * rng.randn(B, 648)
    llr = np.clip(2.0 * y / 0.64, -K.LLR_MAX, K.LLR_MAX).astype(np.float32)
    return p, torch.from_numpy(llr)


def _checks_pass(dec, p):
    """[B] True where every check of the code holds, from its base
    matrix: check (i, z) sums bit j*Z + (z + s) % Z of each block (j, s)
    of row i."""
    Z = int(p["Z"])
    z = np.arange(Z)
    ok = np.ones(dec.shape[0], bool)
    for row in PQ.qc_rows(p):
        par = np.zeros((dec.shape[0], Z), np.int64)
        for j, s in row:
            par += dec[:, j * Z + (z + s) % Z]
        ok &= ~(par % 2).any(axis=1)
    return ok


def _own_sweeps(llr, p, schedule):
    """Each frame's sweeps: the fewest after which its decisions pass
    every check (0 if they pass at the start), else ``N_ITERS``."""
    meta = (p["Z"], p["Nb"], PQ.qc_rows(p))
    count = np.full(llr.shape[0], N_ITERS)
    for k in range(N_ITERS, -1, -1):
        dec, _ = K.qc_bp_resident_plain(llr, "MSA", k, meta, schedule)
        count[_checks_pass(dec.numpy().astype(np.int64), p)] = k
    return count


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_k4_counter_on_the_cpu_route(counters, schedule):
    p, llr = _llrs(11, n_clean=2)
    meta = (p["Z"], p["Nb"], PQ.qc_rows(p))
    K.qc_bp_resident(llr, "MSA", N_ITERS, meta, schedule)
    assert (counters.sweeps, counters.frames) == (0, 0)
    want = _own_sweeps(llr, p, schedule)
    assert list(want[:2]) == [0, 0] and want.max() == N_ITERS
    assert len(set(want[2:])) > 2
    with profile(activities=[ProfilerActivity.CPU]):
        K.qc_bp_resident(llr, "MSA", N_ITERS, meta, schedule)
    assert counters.frames == llr.shape[0]
    assert int(counters.sweeps) == int(want.sum())


def test_k4_counter_noiseless_frames_count_zero(counters):
    p, llr = _llrs(12, n_clean=5)
    meta = (p["Z"], p["Nb"], PQ.qc_rows(p))
    with profile(activities=[ProfilerActivity.CPU]):
        K.qc_bp_resident(llr[:5], "MSA", N_ITERS, meta)
    assert counters.frames == 5 and int(counters.sweeps) == 0


@pytest.mark.card
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_k4_counter_kernel_equals_plain_on_the_card(counters, schedule):
    """802.11n (1944, 3/4) 16-QAM at 11.5 dB, 512 frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    p = PQ.ieee80211n_params(1944, "3/4")
    link = make_qcldpc_awgn_link(qc_params=p, modulation_m=16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2**31 + 9)
    bits, noise = link.draw(gen, 512)
    llr = link.receive(bits, noise, float(link.noise_std_fn(11.5)))
    llr = torch.clamp(llr, -K.LLR_MAX, K.LLR_MAX).contiguous()
    meta = (p["Z"], p["Nb"], PQ.qc_rows(p))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        dec, _ = K.qc_bp_resident(llr, "MSA", N_ITERS, meta, schedule)
    kernel = (int(counters.sweeps), counters.frames)
    counters.sweeps = counters.frames = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        want, _ = K.qc_bp_resident_plain(llr, "MSA", N_ITERS, meta, schedule)
    assert torch.equal(dec, want)
    assert kernel == (int(counters.sweeps), counters.frames)
    assert kernel[1] == 512 and 0 < kernel[0] < 512 * N_ITERS


# ---- K6, the joint demapper, against its plain version on the card ----

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _demap_case(kind, m, shape, scale, seed, dev):
    const = (PM.psk_constellation(m) if kind == "psk"
             else PM.qam_constellation(m)).astype(np.complex64)
    rng = np.random.RandomState(seed)
    noise = rng.randn(*shape) + 1j * rng.randn(*shape)
    y = const[rng.randint(0, m, shape)] + noise * scale
    return const, torch.as_tensor(y.astype(np.complex64), device=dev)


def _k6_and_plain(y, const, nv, maxlog):
    """K6's LLRs (through the public demapper, counted) and the plain
    version's on the same device."""
    bps = int(np.log2(len(const)))
    fn = PM.demodulate_maxlog if maxlog else PM.demodulate_soft
    before = D.demap_joint.launches
    got = fn(y, const, bps, nv, method="joint")
    launched = D.demap_joint.launches - before
    want = PM._demodulate_joint(y, const, bps, nv,
                                PM._max if maxlog else PM._lse)
    return got, want, launched


@pytest.mark.card
@pytest.mark.parametrize("kind,m", [("psk", 2), ("qam", 4), ("psk", 8),
                                    ("qam", 16), ("qam", 64)])
@pytest.mark.parametrize("maxlog", [False, True])
@pytest.mark.parametrize("nv_form", ["scalar", "0-d", "one", "per_symbol"])
def test_k6_equals_the_plain_version_on_the_card(kind, m, maxlog, nv_form):
    dev = _card()
    const, y = _demap_case(kind, m, (64, 999), 0.4, m, dev)
    nv = {"scalar": np.float32(0.3),
          "0-d": torch.tensor(0.3, device=dev),
          "one": torch.tensor([0.3], device=dev),
          "per_symbol": torch.rand(y.shape, device=dev) * 2 + 1e-3}[nv_form]
    got, want, launched = _k6_and_plain(y, const, nv, maxlog)
    assert launched == 1 and got.shape == (64, 999 * int(np.log2(m)))
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("maxlog", [False, True])
def test_k6_layouts_on_the_card(maxlog):
    """Leading axes, a non-contiguous input; an empty input gives an empty
    output without a launch (the plain version cannot reshape one)."""
    dev = _card()
    const, y = _demap_case("qam", 16, (2, 3, 5, 41), 0.5, 7, dev)
    got, want, launched = _k6_and_plain(y, const, 0.25, maxlog)
    assert launched == 1 and got.shape == (2, 3, 5, 164)
    assert torch.equal(got, want)
    strided = y.transpose(1, 3)[..., ::2]
    assert not strided.is_contiguous()
    got, want, launched = _k6_and_plain(strided, const, 0.25, maxlog)
    assert launched == 1 and torch.equal(got, want)
    before = D.demap_joint.launches
    for empty, shape in ((y[:0], (0, 3, 5, 164)), (y[..., :0], (2, 3, 5, 0))):
        got = PM.demodulate_soft(empty, const, 4, 0.25, method="joint")
        assert got.shape == shape and got.dtype == torch.float32
    assert D.demap_joint.launches == before


@pytest.mark.card
@pytest.mark.parametrize("kind,m", [("qam", 4), ("psk", 8), ("qam", 16),
                                    ("qam", 64)])
@pytest.mark.parametrize("maxlog", [False, True])
def test_k6_far_out_symbols_on_the_card(kind, m, maxlog):
    """Symbols far off the constellation with a small noise variance:
    every exp of a point but the nearest underflows; log-weights reach
    ~-1e22."""
    dev = _card()
    const, y = _demap_case(kind, m, (8, 500), 0.1, 11 + m, dev)
    far = torch.as_tensor(
        np.random.RandomState(m).choice([1e1, 1e3, 1e5, 1e7], y.shape),
        dtype=torch.float32, device=dev)
    for nv in (np.float32(1e-3), np.float32(1e-6)):
        got, want, launched = _k6_and_plain(y * far, const, nv, maxlog)
        assert launched == 1 and torch.isfinite(want).all()
        assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("maxlog", [False, True])
def test_k6_leaves_complex128_to_the_plain_version_on_the_card(maxlog):
    """complex128 symbols keep the plain version's float64 distances (the
    CommPy-compatible ``Modem.demodulate`` passes NumPy complex128):
    no launch, the plain version's values; real float32 symbols take K6
    as complex64, bit for bit."""
    dev = _card()
    const, y = _demap_case("qam", 16, (4, 300), 0.4, 5, dev)
    y128 = y.to(torch.complex128) + 1e-9j
    got, want, launched = _k6_and_plain(y128, const, 0.3, maxlog)
    assert launched == 0 and torch.equal(got, want)
    const, y = _demap_case("psk", 2, (4, 300), 0.4, 6, dev)
    got, want, launched = _k6_and_plain(y.real.contiguous(), const, 0.3,
                                        maxlog)
    assert launched == 1 and torch.equal(got, want)
