"""The NR uplink-control polar code of the benchmark, (1024, 512 +
CRC11) with QPSK and CA-SCL-8, against the plain reference of the
benchmark (``portbench/reference/polar1024.py``), which restates TS
38.212 and TS 38.211 and imports nothing of the port, and against
``tests/polar_ref.py``.

Points, frozen sets, CRC and codewords agree exactly; decisions agree
bit for bit (min-sum f, the approximate path metric).  K7 itself runs
only on the card: the tests marked ``card`` hold it to the unrolled
decoder there (``python -m pytest tests/test_torch_polar1024.py
--noconftest -m card``; this file imports no JAX), as ``chip_smoke.py``
Path M does.  Here its plan and route are checked, and a plain model of
its warp (32 / PP frames side by side in the kernel's columns, units,
slot maps, partial sums merged into the g stage a word at a time, the
frozen-subtree cascade, the prune within a frame's lanes) is held to the
plain decoder.
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


# --------------------------------------------- a plain model of K7's warp

M32 = 0xFFFFFFFF
# over the 32 elements i of a word: bit i set where bit lv of i is clear,
# and the factor that repeats a 2^lv-bit word across 32 bits
_CLEAR = [0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF]
_REPEAT = [0xFFFFFFFF, 0x55555555, 0x11111111, 0x01010101, 0x00010001]


def _f(a, b):
    """K7's f: min(|a|, |b|) with the XOR of the sign bits."""
    m = np.minimum(np.abs(a), np.abs(b)).astype(F32)
    sign = (a.view(np.uint32) ^ b.view(np.uint32)) & np.uint32(0x80000000)
    return (m.view(np.uint32) | sign).view(F32)


def _g(a, b, s):
    return np.where(s.astype(bool), b - a, b + a).astype(F32)


def _k7_warp(ch, code, L, vtop):
    """One warp of K7 (``csrc/polar_scl.cu``) over the frames ``ch``
    [32 / PP, N], in the kernel's layout: 32 columns, column = lane =
    frame * PP + slot, for the LLR rows (``Lb``) and for the partial-sum
    words of levels 5 and up (``Cq``, 32 elements a word); a path's state
    per lane (metric, syndrome, last bit, ``clow``, slot maps, payload
    words), a prune's ranking within the frame's PP lanes and its copies
    from the parent's lane (the shuffles), the top ``vtop`` levels
    recomputed from the channel.  Returns the payloads [32 / PP, K]."""
    N, n, K = code.N, code.n, code.K
    PP = 1 << (L - 1).bit_length()
    G = 32 // PP
    lane = np.arange(32)
    p, fr = lane % PP, lane // PP
    base = lane - p
    real = p < L
    Lb = np.zeros((N >> vtop, 32), F32)
    Cq = np.zeros((max(N // 32, 1), 32), np.int64)
    chl = ch.astype(F32)[fr]  # each lane's frame
    rows = K7._crc_rows(code).view(np.uint32) if code.crc else None
    pm = np.where(p == 0, F32(0), F32(1e30)).astype(F32)
    syn = np.zeros(32, np.int64)
    last = np.zeros(32, np.int64)
    clow = np.zeros(32, np.int64)
    lmap = np.repeat(p[:, None], n, 1)
    cmap = lmap.copy()
    words = np.zeros((32, -(-K // 32)), np.int64)
    lam = np.zeros(32, F32)
    prev = 0

    def cget(lv, k):
        r = (1 << lv) + k
        if lv < 5:
            return (clow >> r) & 1
        return (Cq[r >> 5, base + cmap[:, lv]] >> (r & 31)) & 1

    def top(D, lv, k, lo):
        w = 1 << lv
        x = [chl[:, k + q * w] for q in range(1 << D)]
        for s_ in range(D):
            Lv = n - 1 - s_
            half = (1 << D) >> (s_ + 1)
            for q in range(half):
                a, b = x[q], x[q + half]
                x[q] = (_g(a, b, cget(Lv, k + q * w)) if (lo >> Lv) & 1
                        else _f(a, b))
        return x[0]

    def src(l, i, col, lo):
        h, depth = 1 << l, n - l - 1
        if depth > vtop:
            return Lb[2 * h + i, col], Lb[3 * h + i, col]
        return top(depth, l + 1, i, lo), top(depth, l + 1, i + h, lo)

    for d in map(int, K7.polar_units(code.frozen_mask)):
        lo, lev, info, j = d & 2047, (d >> 11) & 15, (d >> 15) & 1, d >> 16
        t = n
        if lo:
            t = (lo & -lo).bit_length() - 1
            h = 1 << t
            sl = base + (lmap[:, t + 1] if t + 1 < n else 0)
            stored = t < n - vtop
            low = np.where(last == 1, M32, 0)
            for lv in range(prev, min(t, 5)):
                c = (clow >> (1 << lv)) & ((1 << (1 << lv)) - 1)
                low ^= (c * _REPEAT[lv]) & _CLEAR[lv]
            if t < 5:
                keep = M32 ^ (((1 << h) - 1) << h)
                clow = (clow & keep) | ((low & ((1 << h) - 1)) << h)
                for i in range(h if stored else 0):
                    v = _g(*src(t, i, sl, lo), (low >> i) & 1)
                    if t == 0:
                        lam = v
                    else:
                        Lb[h + i] = v
            else:
                for w in range(h >> 5):
                    s = low.copy()
                    for lv in range(max(prev, 5), t):
                        m = lv - 5
                        if not (w >> m) & 1:
                            r = (1 << m) + (w & ((1 << m) - 1))
                            s ^= Cq[r, base + cmap[:, lv]]
                    Cq[(h >> 5) + w] = s
                    for ii in range(32 if stored else 0):
                        i = (w << 5) + ii
                        Lb[h + i] = _g(*src(t, i, sl, lo), (s >> ii) & 1)
                cmap[:, t] = p
            lmap[:, t] = p
        for lv in range(min(t, n - vtop) - 1, lev - 1, -1):
            h = 1 << lv
            for i in range(h):
                v = _f(*src(lv, i, lane, lo))
                if lv == 0:
                    lam = v
                else:
                    Lb[h + i] = v
            lmap[:, lv] = p
        if not info and lev:
            W = 1 << lev
            for s_ in range(lev):
                hb = W >> (s_ + 1)
                for k in range(W // 2):
                    i0 = W + (k // hb) * 2 * hb + (k & (hb - 1))
                    a, b = Lb[i0].copy(), Lb[i0 + hb].copy()
                    Lb[i0], Lb[i0 + hb] = _f(a, b), b + a
            for w in range(W):
                pm = (pm + np.maximum(-Lb[W + w], F32(0))).astype(F32)
            last[:] = 0
        elif not info:
            pm = (pm + np.maximum(-lam, F32(0))).astype(F32)
            last[:] = 0
        else:
            c0 = (pm + np.maximum(-lam, F32(0))).astype(F32)
            c1 = (pm + np.maximum(lam, F32(0))).astype(F32)
            cs = np.full((G, 2 * L), np.nan, F32)
            cs[fr[real], p[real]] = c0[real]
            cs[fr[real], L + p[real]] = c1[real]
            k = np.arange(2 * L)
            mine = p.copy()
            sel = np.zeros((G, L), np.int64)
            for x in lane[real]:
                for c, v in ((p[x], c0[x]), (L + p[x], c1[x])):
                    rank = np.sum((cs[fr[x]] < v) | ((cs[fr[x]] == v) & (k < c)))
                    if rank < L:
                        sel[fr[x], rank] = c
            mine[real] = sel[fr[real], p[real]]
            nb = real & (mine >= L)
            q = np.where(nb, mine - L, mine)
            pm = np.where(real, cs[fr, np.minimum(mine, 2 * L - 1)], pm)
            at = base + q  # the parent's lane
            hr = int(rows[j]) if rows is not None else 0
            syn = syn[at] ^ np.where(nb, hr, 0)
            clow, lmap, cmap = clow[at], lmap[at], cmap[at]
            jw = min(j, K - 1) >> 5
            words[:, :jw + 1] = words[at, :jw + 1]
            if j < K:
                words[nb, j >> 5] |= 1 << (j & 31)
            last = nb.astype(np.int64)
        prev = lev
    score = np.where((syn != 0) & (rows is not None), pm + F32(1e20),
                     pm).astype(F32)
    out = np.zeros((G, K), np.int8)
    for f_ in range(G):
        win = 0
        for r in range(1, L):
            if score[f_ * PP + r] < score[f_ * PP + win]:
                win = r
        bits = (words[f_ * PP + win][:, None] >> np.arange(32)) & 1
        out[f_] = bits.reshape(-1)[:K]
    return out


def _k7_model(llr, code, L):
    """K7 on a batch ``llr`` [B, N]: warps of 32 / PP frames, the frames
    past B in the last warp the batch's last frame, their payloads
    dropped."""
    walk = K7.polar_units(code.frozen_mask)
    plan = K7.polar_scl_plan(code.N, L, frozen_level=int(
        ((walk >> 11) & 15).max()))
    G = 32 // plan["paths"]
    B = len(llr)
    warps = -(-B // G)
    idx = np.minimum(np.arange(warps * G), B - 1)
    out = np.concatenate([_k7_warp(llr[idx[w * G:(w + 1) * G]], code, L,
                                   plan["vtop"]) for w in range(warps)])
    return out[:B]


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
    assert np.array_equal(_k7_model(llr, code, L), want)


@pytest.mark.parametrize("L", range(1, 9))
@pytest.mark.parametrize("N, A, crc", [(64, 32, "crc6"), (128, 60, "crc11")])
@pytest.mark.parametrize("level", ["clean", "fails"])
def test_model_of_k7s_warp_at_every_list_size(N, A, crc, L, level):
    """G = 32 / PP frames a warp at every list size, over a batch of one
    warp and three frames more, so the last warp runs on masked frames."""
    code = PP.polar_construct(N, A, crc=crc, design_snr_db=2.0)
    B = 32 // (1 << (L - 1).bit_length()) + 3
    llr = _llr(N, level, B, 11 * N + L)
    want = PP.make_polar_scl_decoder_unrolled(code, list_size=L,
                                              device=CPU)(llr).numpy()
    assert np.array_equal(_k7_model(llr, code, L), want)


# ------------------------------------------------------- K7 on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("L", range(1, 9))
@pytest.mark.parametrize("B", [1, 3, 4099])
@pytest.mark.parametrize("N, A, crc", [(8, 1, "crc6"), (64, 32, "crc6"),
                                       (1024, 512, "crc11")])
@pytest.mark.parametrize("level", ["clean", "fails"])
def test_k7_equals_the_unrolled_decoder_on_the_card(N, A, crc, L, B, level):
    """Every list size (so every G = 32 / PP frames a warp), batches of
    one frame, three, and one warp's worth past a multiple of G, frames
    that pass the CRC and frames that fail it on every path."""
    dev = _card()
    code = PP.polar_construct(N, A, crc=crc, design_snr_db=2.0)
    llr = torch.as_tensor(_llr(N, level, B, 13 * N + 17 * L + B),
                          device=dev)
    got = K7.make_polar_scl_kernel(code, L, device=dev)(llr)
    want = PP.make_polar_scl_decoder_unrolled(code, list_size=L,
                                              device=dev)(llr)
    assert torch.equal(got, want)
    assert K7.polar_scl.warps == -(-B // (32 // (1 << (L - 1).bit_length())))
