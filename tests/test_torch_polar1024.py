"""The NR uplink-control polar code of the benchmark, (1024, 512 +
CRC11) with QPSK and CA-SCL-8, against the plain reference of the
benchmark (``portbench/reference/polar1024.py``), which restates TS
38.212 and TS 38.211 and imports nothing of the port, and against
``tests/polar_ref.py``.

Points, frozen sets, CRC and codewords agree exactly; decisions agree
bit for bit (min-sum f, the approximate path metric).  K7 itself runs
only on the card (``chip_smoke.py`` Path M holds it to the plain decoder
there); here its plan and route are checked, and a plain model of its
walk (units, slot maps, partial sums merged into the g stage, the
frozen-subtree cascade, the prune) is held to the plain decoder.
"""
import numpy as np
import pytest
import torch

import polar_ref
from commpy_tpu_torch.kernels import polar_scl as K7
from commpy_tpu_torch.models import make_polar_awgn_link
from commpy_tpu_torch.ops import modem as M
from commpy_tpu_torch.ops import polar as PP
from portbench.reference import draws
from portbench.reference import polar1024 as R

torch.set_num_threads(1)
CPU = torch.device("cpu")
F32 = np.float32
CRC11 = (1, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1)


def _ref(N, A):
    return R.Polar1024({"frame_bits": A, "mother_length": N, "list_size": 8,
                        "design_snr_db": 2.0}, CPU)


@pytest.mark.parametrize("label", range(4))
def test_nr_qpsk_is_38_211s_formula(label):
    b0, b1 = label >> 1, label & 1
    want = ((1 - 2 * b0) + 1j * (1 - 2 * b1)) / np.sqrt(2)
    got = M.nr_qpsk_constellation()
    assert got.dtype == np.complex64
    assert got[label] == np.complex64(want)


@pytest.mark.parametrize("N, A, crc", [(1024, 512, "crc11"), (64, 32, "crc6")])
def test_reference_frozen_set_is_the_ports(N, A, crc):
    code = PP.polar_construct(N, A, crc=crc, design_snr_db=2.0)
    frozen = R.bhattacharyya_frozen(N, code.k_total, 2.0)
    assert np.array_equal(frozen, code.frozen_mask)


def test_reference_crc_and_codeword_are_the_ports():
    ref = _ref(1024, 512)
    code = PP.polar_construct(1024, 512, crc="crc11", design_snr_db=2.0)
    bits = torch.as_tensor(np.random.default_rng(11).integers(
        0, 2, (16, 512)), dtype=torch.int8)
    port_crc = PP.crc_encode_table(code.crc, 512)
    want_crc = (bits.numpy().astype(np.int64) @ port_crc) % 2
    assert np.array_equal(ref.crc_bits(bits).numpy(), want_crc)
    for row in bits.numpy()[:2]:
        assert np.array_equal(ref.crc_bits(torch.as_tensor(row)).numpy(),
                              polar_ref.crc_remainder_np(row, CRC11))
    want = PP.polar_encode(code, bits, device=CPU)
    assert torch.equal(ref.encode(bits), want)


def _llr(N, level, B, seed):
    mean, sd = {"clean": (2.0, 2.0), "mixed": (1.0, 3.0),
                "fails": (0.0, 3.0)}[level]
    rng = np.random.default_rng(seed)
    return (mean + rng.standard_normal((B, N)) * sd).astype(np.float32)


@pytest.mark.parametrize("level", ["clean", "mixed", "fails"])
@pytest.mark.parametrize("N, A, B", [(64, 21, 24), (256, 117, 8),
                                     (1024, 512, 2)])
def test_three_scl8_decoders_agree(N, A, B, level):
    """The port's plain SCL-8 (the CPU scan), the benchmark's reference
    and ``polar_ref.scl_decode_np``: the same payloads, bit for bit."""
    ref = _ref(N, A)
    code = PP.polar_construct(N, A, crc="crc11", design_snr_db=2.0)
    llr = _llr(N, level, B, N + len(level))
    port = PP.polar_scl_decode(code, llr, list_size=8, device=CPU).numpy()
    got = ref.decode(torch.as_tensor(llr)).numpy()
    assert np.array_equal(got, port)
    info = code.info_positions

    def crc_ok(bits):
        return np.array_equal(polar_ref.crc_remainder_np(bits[:A], CRC11),
                              bits[A:])

    for b in range(B):
        u, _, _ = polar_ref.scl_decode_np(llr[b], code.frozen_mask, 8,
                                          crc_check=crc_ok)
        assert np.array_equal(u[info][:A], port[b])
    if level == "fails":  # every path of these frames fails the CRC
        llr_t = torch.as_tensor(llr)
        _, pm, u_all = PP.make_polar_scl_decoder(
            code, list_size=8, full=True, device=CPU)(llr_t)
        passing = [[crc_ok(u_all[b, p].numpy()[info]) for p in range(8)]
                   for b in range(B)]
        assert not any(any(row) for row in passing)


@pytest.mark.parametrize("snr", [4.0, 4.5, 5.0])
def test_link_with_nr_qpsk_equals_the_reference(snr):
    code = PP.polar_construct(1024, 512, crc="crc11", design_snr_db=2.0)
    link = make_polar_awgn_link(code=code, decoder="scl", list_size=8,
                                constellation=M.nr_qpsk_constellation(),
                                device=CPU)
    ref = _ref(1024, 512)
    ns = float(np.float32(link.noise_std_fn(snr)))
    assert ref.noise_std(snr) == ns
    gen = draws.round_generator(2**40 + 17, 2, 1, CPU)
    bits, noise = link.draw(gen, 6)
    gen = draws.round_generator(2**40 + 17, 2, 1, CPU)
    rbits, rnoise = draws.draw(gen, 6, 512, 512, CPU)
    assert torch.equal(bits, rbits) and torch.equal(noise, rnoise)
    got, _ = ref.transceive(bits, noise, ns)
    assert torch.equal(got, link.transceive(bits, noise, ns))


def test_link_defaults_are_unchanged():
    code = PP.polar_construct(64, 32, crc="crc6")
    old = make_polar_awgn_link(code=code, list_size=4, device=CPU)
    psk = make_polar_awgn_link(code=code, list_size=4, device=CPU,
                               constellation=M.psk_constellation(2))
    assert old.extras["Es"] == psk.extras["Es"]
    assert old.extras["bps"] == psk.extras["bps"] == 1
    gen = draws.round_generator(5, 0, 0, CPU)
    bits, noise = old.draw(gen, 8)
    assert torch.equal(old.transceive(bits, noise, 0.9),
                       psk.transceive(bits, noise, 0.9))


@pytest.mark.parametrize("args, takes", [
    ((1024, 8), True), ((2, 1), True), ((64, 3), True), ((512, 5), True),
    ((2048, 8), False), ((1, 1), False), ((96, 4), False), ((64, 9), False),
    ((64, 0), False), ((64, 8, "exact"), False),
    ((64, 8, "minsum", "exact"), False),
    ((64, 8, "minsum", "approx", True), False),
    ((64, 8, "minsum", "approx", False, 33), False),
])
def test_polar_scl_plan_takes_and_refuses(args, takes):
    plan = K7.polar_scl_plan(*args)
    assert (plan is not None) == takes
    if takes:
        N, L = args[:2]
        assert plan["paths"] >= L and plan["paths"] & (plan["paths"] - 1) == 0
        assert plan["threads"] == 32
        rows = N >> plan["vtop"]
        assert plan["smem_bytes"] == 96 + 4 * rows * plan["paths"] + 4 * -(
            -N * plan["paths"] // 32)
        assert 0 <= plan["vtop"] <= min(3, N.bit_length() - 2)


@pytest.mark.parametrize("N, frozen_level, vtop", [
    (1024, 6, 3), (1024, 7, 2), (1024, 8, 1), (1024, 9, 0), (8, 0, 2),
    (8, 1, 1), (4, 0, 1), (2, 0, 0)])
def test_plan_keeps_the_top_levels_above_the_frozen_subtrees(N, frozen_level,
                                                             vtop):
    assert K7.polar_scl_plan(N, 8, frozen_level=frozen_level)["vtop"] == vtop


def test_plan_of_the_cells_code():
    code = PP.polar_construct(1024, 512, crc="crc11", design_snr_db=2.0)
    level = int((K7.polar_units(code.frozen_mask) >> 11 & 15).max())
    plan = K7.polar_scl_plan(1024, 8, crc_bits=11, frozen_level=level)
    assert plan == {"paths": 8, "threads": 32, "vtop": 3,
                    "smem_bytes": 5216}


@pytest.mark.parametrize("backend, device_type, kw, want", [
    ("auto", "cuda", {}, "kernel"),
    ("auto", "cpu", {}, "scan"),
    ("torch", "cuda", {}, "unrolled"),
    ("torch", "cpu", {}, "scan"),
    ("cuda", "cuda", {}, "kernel"),
    ("auto", "cuda", {"list_size": 16}, "unrolled"),
    ("auto", "cuda", {"rule": "exact"}, "unrolled"),
    ("auto", "cuda", {"pm_rule": "exact"}, "unrolled"),
])
def test_route(backend, device_type, kw, want):
    code = PP.polar_construct(1024, 512, crc="crc11")
    args = dict(list_size=8, rule="minsum", pm_rule="approx") | kw
    assert PP.polar_scl_route(code, args["list_size"], args["rule"],
                              args["pm_rule"], backend, device_type) == want


def test_route_refuses():
    code = PP.polar_construct(64, 32, crc="crc6")
    with pytest.raises(ValueError, match="CUDA tensor"):
        PP.polar_scl_decode(code, np.zeros((1, 64), np.float32),
                            backend="cuda", device=CPU)
    with pytest.raises(ValueError, match="backend"):
        PP.polar_scl_decode(code, np.zeros((1, 64), np.float32),
                            backend="pallas", device=CPU)
    big = PP.polar_construct(2048, 512)
    with pytest.raises(NotImplementedError):
        PP.polar_scl_route(big, 8, "minsum", "approx", "cuda", "cuda")
    syst = PP.polar_construct(64, 32, systematic=True)
    assert PP.polar_scl_route(syst, 8, "minsum", "approx", "auto",
                              "cuda") == "unrolled"
    with pytest.raises(ValueError, match="float32 CUDA"):
        K7.polar_scl(torch.zeros((1, 64)), torch.zeros(1, dtype=torch.int32),
                     None, 32, 8, True)


@pytest.mark.parametrize("N, lev", [(8, 3), (64, 6), (1024, 10)])
def test_polar_units_cover_the_leaves_in_order(N, lev):
    code = PP.polar_construct(N, N // 4, design_snr_db=2.0)
    units = K7.polar_units(code.frozen_mask)
    lo, level = units & 2047, (units >> 11) & 15
    info, ordinal = (units >> 15) & 1, units >> 16
    assert lo[0] == 0 and np.array_equal(lo[1:], (lo + (1 << level))[:-1])
    assert lo[-1] + (1 << level[-1]) == N
    assert np.array_equal(lo[info == 1], code.info_positions)
    assert np.array_equal(ordinal[info == 1], np.arange(code.k_total))
    assert np.all(level[info == 1] == 0)
    for a, w in zip(lo[info == 0], level[info == 0]):
        assert code.frozen_mask[a:a + (1 << w)].all()
        assert a % (1 << w) == 0


# --------------------------------------------- a plain model of K7's walk

def _f(a, b):
    return F32(np.sign(a) * np.sign(b) * min(abs(a), abs(b)))


def _k7_model(llr, code, P):
    """One frame along K7's walk (``csrc/polar_scl.cu``): every path
    writes only its own slot, paths are copied by their slot maps, the
    partial sums of level t are made in the g stage at level t, and an
    all-frozen subtree takes its leaves level-parallel."""
    N, n, K = code.N, code.n, code.K
    PS = 1 << (P - 1).bit_length()
    Lb = np.zeros((N, PS), F32)
    Cb = np.zeros((N, PS), np.int64)
    rows = K7._crc_rows(code).view(np.uint32) if code.crc else None
    pm = [F32(0.0)] + [F32(1e30)] * (PS - 1)
    syn, last = [0] * PS, [0] * PS
    lmap = [[p] * n for p in range(PS)]
    cmap = [[p] * n for p in range(PS)]
    bits = [[0] * K for _ in range(PS)]
    lam = [F32(0)] * PS
    prev = 0
    ch = llr.astype(F32)
    for d in map(int, K7.polar_units(code.frozen_mask)):
        lo, lev, info, j = d & 2047, (d >> 11) & 15, (d >> 15) & 1, d >> 16
        t = n
        if lo:
            t = (lo & -lo).bit_length() - 1
            h = 1 << t
            for p in range(PS):
                sl = lmap[p][t + 1] if t + 1 < n else None
                for i in range(h):
                    s = last[p]
                    for lv in range(prev, t):
                        if not (i >> lv) & 1:
                            s ^= Cb[(1 << lv) + (i & ((1 << lv) - 1)),
                                    cmap[p][lv]]
                    Cb[h + i, p] = s
                    a, b = ((ch[i], ch[i + h]) if sl is None else
                            (Lb[2 * h + i, sl], Lb[3 * h + i, sl]))
                    v = F32(b - a) if s else F32(b + a)
                    if t == 0:
                        lam[p] = v
                    else:
                        Lb[h + i, p] = v
                cmap[p][t] = lmap[p][t] = p
        for lv in range(t - 1, lev - 1, -1):
            h = 1 << lv
            for p in range(PS):
                for i in range(h):
                    a, b = ((ch[i], ch[i + h]) if lv + 1 == n else
                            (Lb[2 * h + i, p], Lb[3 * h + i, p]))
                    if lv == 0:
                        lam[p] = _f(a, b)
                    else:
                        Lb[h + i, p] = _f(a, b)
                lmap[p][lv] = p
        if not info:
            W = 1 << lev
            for s_ in range(lev):
                hb = W >> (s_ + 1)
                for p in range(PS):
                    for k in range(W // 2):
                        i0 = (k // hb) * 2 * hb + (k & (hb - 1))
                        a, b = Lb[W + i0, p], Lb[W + i0 + hb, p]
                        Lb[W + i0, p], Lb[W + i0 + hb, p] = _f(a, b), b + a
            for p in range(PS):
                leaves = [lam[p]] if lev == 0 else Lb[W:2 * W, p]
                for x in leaves:
                    pm[p] = F32(pm[p] + max(-x, F32(0)))
                last[p] = 0
        else:
            cand = [F32(pm[c % P] + max(lam[c % P] if c >= P else
                                        -lam[c % P], F32(0)))
                    for c in range(2 * P)]
            rank = [sum((cand[k] < cand[c]) or (cand[k] == cand[c] and k < c)
                        for k in range(2 * P)) for c in range(2 * P)]
            old = (list(syn), [list(x) for x in lmap],
                   [list(x) for x in cmap], [list(x) for x in bits])
            for r in range(P):
                c = rank.index(r)
                q, nb = c % P, int(c >= P)
                pm[r] = cand[c]
                syn[r] = old[0][q] ^ (int(rows[j]) if nb and rows is not None
                                      else 0)
                lmap[r], cmap[r], bits[r] = (list(old[1][q]),
                                             list(old[2][q]),
                                             list(old[3][q]))
                if nb and j < K:
                    bits[r][j] = 1
                last[r] = nb
        prev = lev
    score = [F32(pm[r] + F32(1e20)) if rows is not None and syn[r] else pm[r]
             for r in range(P)]
    return np.array(bits[int(np.argmin(score))], np.int8)


@pytest.mark.parametrize("N, A, crc, L, B", [
    (64, 32, "crc6", 8, 8), (64, 20, None, 4, 8), (128, 60, "crc11", 3, 6),
    (256, 128, "crc11", 8, 3), (16, 4, None, 2, 8), (8, 1, None, 5, 8),
    (1024, 512, "crc11", 8, 1)])
@pytest.mark.parametrize("level", ["clean", "fails"])
def test_model_of_k7s_walk_equals_the_plain_decoder(N, A, crc, L, B, level):
    code = PP.polar_construct(N, A, crc=crc, design_snr_db=2.0)
    llr = _llr(N, level, B, 7 * N + L)
    want = PP.make_polar_scl_decoder_unrolled(code, list_size=L,
                                              device=CPU)(llr).numpy()
    got = np.stack([_k7_model(x, code, L) for x in llr])
    assert np.array_equal(got, want)
