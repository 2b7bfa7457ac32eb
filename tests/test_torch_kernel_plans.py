"""Launch plans of the redesigned kernels, checked on the CPU.

K5 (``kernels/qc_bp.py:streamed_plan``) must fit the shared memory of an
H100 block and the shared memory and registers of an SM, with a message
store for its frames in flight, for every code the repository has;
``select_backend`` must
route every code as before; K5's packed tables must say what the graph
says; K3 (``kernels/bcjr.py:bcjr_plan``) must place the history where the
bench shapes need it.  Pure functions: no JAX, no kernel.
"""
import os

import numpy as np
import pytest
import torch

from commpy_tpu_torch.kernels import bcjr as BK
from commpy_tpu_torch.kernels import qc_bp as K
from commpy_tpu_torch.ops import dvbs2 as PD
from commpy_tpu_torch.ops import ldpc as PL
from commpy_tpu_torch.ops import nrldpc as PN
from commpy_tpu_torch.ops import qcldpc as PQ


def _code(name):
    kind, *rest = name.split("-")
    if kind == "80211n":
        return PQ.ieee80211n_params(int(rest[0]), rest[1])
    if kind == "wimax":
        return PL._maybe_qc_params(PL.get_ldpc_code_params(
            os.path.join(PL.DESIGNS, "wimax", "1440.720.txt")))
    if kind == "dvbs2":
        n = int(rest[0])
        return PD.dvbs2_qc_params(PD.synthetic_address_table(n, "1/2"), n,
                                  "1/2")
    return PN.nr_code_params(int(rest[0][2:]), int(rest[1]))


# every code of the repository and how backend='auto' routes it
# (flooding, layered), as it did before K5's redesign
ROUTES = {f"80211n-{n}-{r}": ("resident", "resident")
          for (n, r) in sorted(PQ.IEEE80211N_BASE)}
ROUTES.update({
    "wimax-1440": ("resident", "resident"),
    "dvbs2-16200": ("torch", "streamed"),
    "dvbs2-64800": ("torch", "torch"),
    "nr-bg1-208": ("torch", "streamed"),
    "nr-bg1-384": ("torch", "streamed"),
    "nr-bg2-208": ("torch", "streamed"),
    "nr-bg2-384": ("torch", "streamed"),
})


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_select_backend_routes_every_code_as_before(name):
    p = _code(name)
    assert (PQ.select_backend(p, "flooding"),
            PQ.select_backend(p, "layered")) == ROUTES[name]


def _graph(p):
    return K._graph((p["Z"], p["Nb"], PQ.qc_rows(p)), PQ._pos_masks(p))


def _synthetic(Z, Nb, rows, pos_masks=()):
    """A QC code's params with check block rows ``rows`` (block columns;
    shifts made up), for routing only."""
    K_ = max(map(len, rows))
    bj = np.full((len(rows), K_), -1)
    bs = np.zeros((len(rows), K_), np.int64)
    for i, r in enumerate(rows):
        bj[i, :len(r)] = r
        bs[i, :len(r)] = [(7 * i + 3 * k) % Z for k in range(len(r))]
    return {"Z": Z, "Nb": Nb, "Mb": len(rows), "K": K_, "block_j": bj,
            "block_s": bs, "pos_masks": list(pos_masks)}


# synthetic codes at and just past each limit K4 and K5 hold a code to on
# the card, and where backend='auto' must send them (flooding, layered)
LIMITS = {
    "row-of-32": (_synthetic(8, 32, [list(range(32))]),
                  ("resident", "resident")),
    "row-of-33": (_synthetic(8, 33, [list(range(33))]), ("torch", "torch")),
    "z-1024": (_synthetic(1024, 2, [[0, 1]]), ("resident", "resident")),
    "z-1032": (_synthetic(1032, 2, [[0, 1]]), ("torch", "torch")),
    "repeat-z-512": (_synthetic(512, 2, [[0, 0, 1]]),
                     ("resident", "resident")),
    "repeat-z-520": (_synthetic(520, 2, [[0, 0, 1]]), ("resident", "torch")),
    # 700 rows of 32 blocks at Z=1: the frame fits resident_smem_bytes's
    # count, but not with the graph tables K4 keeps beside it
    "tables-past-227kb": (_synthetic(1, 32, [list(range(32))] * 700),
                          ("torch", "streamed")),
    "masks-z-512": (_synthetic(512, 2, [[0, 1]], [(0, 1, (3,))]),
                    ("torch", "streamed")),
    "masks-z-520": (_synthetic(520, 2, [[0, 1]], [(0, 1, (3,))]),
                    ("torch", "torch")),
}


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_select_backend_names_no_kernel_that_refuses_the_code(name):
    p, routes = LIMITS[name]
    g = _graph(p)
    sizes = (g["Z"], g["Nb"], g["Mb"], g["E"], g["kmax"])
    repeat = bool((g["row5"] < 0).any())
    for schedule, want in zip(("flooding", "layered"), routes):
        assert PQ.select_backend(p, schedule) == want
        for kernel in ("resident", "streamed"):
            takes = kernel == "resident" or schedule == "layered"
            try:
                if kernel == "resident":
                    K.resident_plan(*sizes, schedule, repeat)
                else:
                    Z, Nb, _, E, kmax = sizes
                    K.streamed_plan(Z, Nb, kmax, E, 1)
            except (ValueError, NotImplementedError):
                takes = False
            if kernel == "resident" and p["pos_masks"]:
                takes = False
            # the router names a kernel exactly when it takes the code
            # and no kernel before it in the order K4, K5 does
            if want == kernel:
                assert takes
            elif want == "torch" or (want == "streamed"
                                     and kernel == "resident"):
                assert not takes


@pytest.mark.parametrize("msg_io", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(n for n, r in ROUTES.items()
                                        if n != "dvbs2-64800"))
def test_streamed_plan_fits_shared_memory_and_registers(name, msg_io):
    g = _graph(_code(name))
    for B in (1, 397, 512, 4096):
        plan = K.streamed_plan(g["Z"], g["Nb"], g["kmax"], g["E"], B, msg_io)
        assert plan["smem_bytes"] <= K.SMEM_LIMIT == 232_448
        # the SM holds its blocks at once: each reserves 1 KB of shared
        # memory besides its own, and its threads' registers
        fps = plan["frames_per_sm"]
        assert 1 <= fps <= K.SM_BLOCKS
        assert fps * (plan["smem_bytes"] + 1024) <= K.SM_SMEM
        assert (fps * plan["threads"] * K.STREAMED_REGS[plan["kmax_t"]]
                <= K.SM_REGS == 65_536)
        assert plan["grid"] == min(B, fps * 132)
        assert plan["Zp"] % 8 == 0 and g["Z"] <= plan["Zp"] < g["Z"] + 8
        assert plan["kmax_t"] in K.STREAMED_KMAX and g["kmax"] <= \
            plan["kmax_t"]
        # the store holds the frames in flight, not all B
        assert plan["store_elems"] == plan["grid"] * g["E"] * plan["Zp"]
        assert plan["store_bytes"] == plan["store_elems"] * (
            2 if msg_io == "bf16" else 4)
        assert plan["threads"] % 32 == 0 and plan["threads"] >= g["Z"]


def test_streamed_plan_frames_in_flight_at_the_bench_code():
    # DVB-S2-class 16200: shared memory holds two float32 blocks (85.7 KB
    # each) or three bfloat16 ones (75.6 KB) an SM, and 72 registers a
    # thread two 384-thread blocks; 252 KB of float32 messages a frame
    g = _graph(_code("dvbs2-16200"))
    args = (g["Z"], g["Nb"], g["kmax"], g["E"])
    f32 = K.streamed_plan(*args, 512, "f32")
    bf16 = K.streamed_plan(*args, 512, "bf16")
    assert (f32["frames_per_sm"], f32["grid"]) == (2, 264)
    assert (bf16["frames_per_sm"], bf16["grid"]) == (2, 264)
    assert f32["store_bytes"] == 2 * bf16["store_bytes"] == 264 * 252_000
    assert K.streamed_plan(*args, 397, "bf16")["grid"] == 264
    assert K.streamed_plan(*args, 1, "f32")["grid"] == 1
    assert K.streamed_plan(*args, 512, "f32", sms=114)["grid"] == 228
    # NR BG1 at Z=384: one 175 KB block an SM, every SM busy
    g = _graph(_code("nr-bg1-384"))
    nr = K.streamed_plan(g["Z"], g["Nb"], g["kmax"], g["E"], 512, "f32")
    assert (nr["frames_per_sm"], nr["grid"]) == (1, 132)
    with pytest.raises(ValueError, match="too large even for the streamed"):
        g = _graph(_code("dvbs2-64800"))
        K.streamed_plan(g["Z"], g["Nb"], g["kmax"], g["E"], 8, "f32")


@pytest.mark.parametrize("meta", [
    (64, 12, (((0, 0), (1, 3), (0, 17), (2, 5)),
              ((2, 1), (3, 0), (4, 9), (3, 33)), ((4, 2), (5, 7), (6, 0)),
              ((6, 11), (7, 4), (8, 0), (6, 40), (7, 1)),
              ((8, 5), (9, 0), (10, 3)), ((10, 8), (11, 0), (9, 21)),
              ((11, 13),))),
    "dvbs2-16200", "nr-bg1-208"], ids=["repeat-col", "dvbs2", "nr-bg1"])
def test_streamed_packed_tables_say_what_the_graph_says(meta):
    if isinstance(meta, str):
        p = _code(meta)
        g = _graph(p)
    else:
        g = K._graph(meta)
    Z, E = g["Z"], g["E"]
    edge = g["edge5"].astype(np.int64)
    assert np.array_equal(edge >> 11, g["ej"] * Z)
    assert np.array_equal(edge & 1023, g["es"])
    row = g["row5"].view(np.uint32).astype(np.int64)
    assert np.array_equal(row & 0xFFFF, g["row_start"][:-1])
    assert np.array_equal((row >> 16) & 0x7FFF, np.diff(g["row_start"]))
    for i in range(g["Mb"]):
        e0, e1 = g["row_start"][i], g["row_start"][i + 1]
        js = list(g["ej"][e0:e1])
        rep = [js[k] in js[:k] for k in range(len(js))]
        assert list((edge[e0:e1] >> 10) & 1) == rep
        assert bool(row[i] >> 31) == any(rep)
        if g["keep"] is not None:
            bits = g["keep5"].view(np.uint32)[i]
            for k in range(e1 - e0):
                assert np.array_equal((bits >> k) & 1, g["keep"][e0 + k])
    assert (g["keep5"] is None) == (g["keep"] is None)
    assert E == len(edge)


@pytest.mark.parametrize("T,R,hist", [
    (128, 12288, "shared"),   # NII (128, 0), L=6144, B=256: Path C
    (256, 4096, "shared"),    # whole frame, L=256, B=4096
    (320, 6144, "global"),    # warmup window (256, 32), L=6144, B=256
])
def test_bcjr_plan_at_the_bench_shapes(T, R, hist):
    plan = BK.bcjr_plan(T, 4, R)
    assert plan["hist"] == hist
    # the history: 64 KB, 128 KB and 160 KB at 32 lanes, S = 4
    shared = BK.bcjr_plan(T, 4, R, hist="shared")["smem_bytes"]
    assert shared == {128: 65_536, 256: 131_072, 320: 163_840}[T]
    assert shared <= BK.SMEM_LIMIT
    assert plan["threads"] == 2 * 4 * 32 and plan["blocks"] == R // 32
    # shared memory holds all the grid at once, or the plan goes global
    if hist == "shared":
        assert plan["blocks"] <= plan["blocks_per_sm"] * 132
    else:
        assert plan["blocks"] > (BK.SM_SMEM // (shared + 1024)) * 132
        assert plan["smem_bytes"] == 0


def test_bcjr_plan_sends_s16_at_t320_to_device_memory():
    for R in (96, 6144):
        assert BK.bcjr_plan(320, 16, R)["hist"] == "global"
    with pytest.raises(ValueError, match="shared memory"):
        BK.bcjr_plan(320, 16, 96, hist="shared")
    with pytest.raises(ValueError, match="hist must be"):
        BK.bcjr_plan(32, 4, 96, hist="l2")
    # short frames of every state count fit
    for S in (2, 4, 8, 16):
        assert BK.bcjr_plan(33, S, 130)["hist"] == "shared"


# K3's two forms: the lane form on the LTE pass shape, the state form where
# 2 R threads do not fill the card, and the lane form's walk itself

def _rsc(S):
    from commpy_tpu_torch.ops.trellis import Trellis

    mem, g, fb = {2: (1, 3, 3), 4: (2, 7, 5), 8: (3, 15, 13),
                  16: (4, 0o37, 0o21)}[S]
    return Trellis(np.array([mem]), np.array([[1, g]]), fb, "rsc")


def _relabelled():
    """The 8-state RSC code with states 1-7 relabelled: bijective, not
    shift-structured."""
    import copy

    t = copy.copy(_rsc(8))
    perm = np.r_[0, 1 + np.random.RandomState(0).permutation(7)]
    nst = np.empty_like(t.next_state_table)
    out = np.empty_like(t.output_table)
    nst[perm] = perm[t.next_state_table]
    out[perm] = t.output_table
    t.next_state_table, t.output_table = nst, out
    t._build_inverse_tables()
    return t


@pytest.mark.parametrize("T,S,R,form", [
    (128, 8, 48 * 1024, "lane"),   # the LTE pass: 48 NII windows, F = 1024
    (128, 8, 1, "state"),          # one lane
    (6144, 4, 1, "state"),         # the turbo stream's pass
    (3, 8, 1024, "state"),         # the LTE tail betas
    (128, 4, 12288, "state"),      # the bench shapes
    (256, 4, 4096, "state"),
    (320, 4, 6144, "state"),
])
def test_bcjr_plan_form_by_shape(T, S, R, form):
    plan = BK.bcjr_plan(T, S, R)
    assert plan["form"] == form
    assert plan["threads"] == (64 if form == "lane" else 2 * S * 32)
    # a trellis without the shift register's maps never takes the lane form
    assert BK.bcjr_plan(T, S, R, shift=False)["form"] == "state"


def test_bcjr_plan_lane_form_at_the_lte_pass():
    plan = BK.bcjr_plan(128, 8, 48 * 1024)
    # 4 KB of history a lane: shared memory would hold 56 lanes an SM
    assert plan["hist"] == "global" and plan["smem_bytes"] == 0
    assert plan["blocks"] == 48 * 1024 // 32
    forced = BK.bcjr_plan(128, 8, 48 * 1024, hist="shared")
    assert forced["smem_bytes"] == 4 * 128 * 8 * 32


@pytest.mark.parametrize("form", ["lane", "state"])
def test_bcjr_plan_form_override(form):
    for T, S, R in ((128, 8, 49152), (3, 8, 1024), (33, 16, 1)):
        plan = BK.bcjr_plan(T, S, R, form=form)
        assert plan["form"] == form


@pytest.mark.parametrize("bad", ["lanes", "warp", 1])
def test_bcjr_plan_raises_on_a_bad_form(bad):
    with pytest.raises(ValueError, match="form must be"):
        BK.bcjr_plan(128, 8, 49152, form=bad)


def test_bcjr_plan_lane_form_needs_the_shift_maps():
    with pytest.raises(ValueError, match="shift register"):
        BK.bcjr_plan(128, 8, 49152, form="lane", shift=False)


def test_lane_bits_only_for_shift_register_maps():
    from commpy_tpu_torch.ops.turbo import lte_trellis

    for S in (2, 4, 8, 16):
        assert BK._lane_bits(_rsc(S)) is not None
    assert BK._lane_bits(lte_trellis()) is not None
    assert BK._lane_bits(_relabelled()) is None


def _lane_form_walk(syn, pan, li, trellis, mode, valid=None, first=None,
                    boundary=None, io_dtype="f32", renorm_every=0):
    """The lane form's own walk (csrc/bcjr.cu ``bcjr_kernel_lanes``) in
    PyTorch over all lanes at once: the forward and backward halves, the
    shift register's neighbours chosen by the pred and succ bits, e's two
    reductions once each, the renormalisation by a count since the last.
    Returns what the wrapper returns with ``posterior=True``."""
    mode_, (_, _, which, sign), w1, w2, li_io, valid, first, a0, bT = \
        BK._prepare(syn, pan, li, trellis, mode == "maxlog", valid, first,
                    io_dtype, boundary, "linear" if mode == "linear" else None,
                    False, renorm_every)
    lse2 = BK._lse2(mode_)
    pred, succ = BK._lane_bits(trellis)
    T, R = w1.shape
    S = trellis.number_states
    H, h = S // 2, T // 2
    x1, x2, lf = w1.float(), w2.float(), li_io.float()

    def branches(t):
        g = []
        for u in range(2):
            row = []
            for d in range(S):
                w = x2[t] if which[u, d] else x1[t]
                w = -w if sign[u, d] < 0 else w
                row.append(w + lf[t] if u else w)
            g.append(row)
        return g

    def keep(new, old, t):
        if valid is None:
            return new
        return [torch.where(valid[t], n, o) for n, o in zip(new, old)]

    def alpha_step(a, g, t):
        na = []
        for d in range(S):
            p = 2 * (d % H)
            x0, y0 = (a[p + 1], a[p]) if pred >> d & 1 else (a[p], a[p + 1])
            na.append(lse2(x0 + g[0][d], y0 + g[1][d]))
        return keep(na, a, t)

    def cands(v, g):
        q0 = [v[d] + g[0][d] for d in range(S)]
        q1 = [v[d] + g[1][d] for d in range(S)]
        c0, c1 = [], []
        for s in range(S):
            n = s // 2
            sw = succ >> s & 1
            c0.append(q0[n + H] if sw else q0[n])
            c1.append(q1[n] if sw else q1[n + H])
        return c0, c1

    def app(al, c0, c1):
        p0 = [al[s] + c0[s] for s in range(S)]
        p1 = [al[s] + c1[s] for s in range(S)]
        o = H
        while o >= 1:
            for i in range(o):
                p0[i] = lse2(p0[i], p0[i + o])
                p1[i] = lse2(p1[i], p1[i + o])
            o //= 2
        return p1[0] - p0[0]

    def renorm(v, since):
        if renorm_every and since == renorm_every:
            mx = v[0]
            for s in range(1, S):
                mx = torch.maximum(mx, v[s])
            return [x - mx for x in v], 0
        return v, since

    if a0 is not None:
        a, b = list(a0), list(bT)
    else:
        exact = (torch.ones(R, dtype=torch.bool) if valid is None
                 else first)
        a = [torch.zeros(R) if s == 0 else
             torch.where(exact, BK.NEG, 0.0).float() for s in range(S)]
        b = [torch.zeros(R) for _ in range(S)]
    hist = {}
    fs = bs = 0
    for t in range(h):
        hist[t] = a
        a, fs = renorm(alpha_step(a, branches(t), t), fs + 1)
    for t in range(T - 1, h - 1, -1):
        hist[t] = b
        c0, c1 = cands(b, branches(t))
        b, bs = renorm(keep([lse2(x, y) for x, y in zip(c0, c1)], b, t),
                       bs + 1)
    e = torch.empty((T, R), dtype=w1.dtype)
    for t in range(h, T):
        g = branches(t)
        e[t] = app(a, *cands(hist[t], g)).to(e.dtype)
        a, fs = renorm(alpha_step(a, g, t), fs + 1)
    for t in range(h - 1, -1, -1):
        c0, c1 = cands(b, branches(t))
        e[t] = app(hist[t], c0, c1).to(e.dtype)
        b, bs = renorm(keep([lse2(x, y) for x, y in zip(c0, c1)], b, t),
                       bs + 1)
    return BK._finish(e, li, torch.stack(a), torch.stack(b), True, boundary)


@pytest.mark.parametrize("variant", ["plain", "masked", "boundary"])
@pytest.mark.parametrize("mode", ["exact", "maxlog", "linear"])
@pytest.mark.parametrize("S", [2, 4, 8, 16])
def test_lane_form_walk_matches_the_plain_version(S, mode, variant):
    """The lane form's walk equals ``bcjr_appdiff_plain`` in every bit:
    T = 1, 2, 7 and 33 (halves empty, of one step, odd), R = 37,
    renorm_every 0, 1 and 4, f32 and bf16 io."""
    case = S + 3 * ["exact", "maxlog", "linear"].index(mode) + \
        7 * ["plain", "masked", "boundary"].index(variant)
    rng = np.random.RandomState(case)
    for T in (1, 2, 7, 33):
        R = 37
        syn, pan = (torch.as_tensor(rng.randn(T, R).astype(np.float32) * 4)
                    for _ in range(2))
        li = torch.as_tensor(rng.randn(T, R).astype(np.float32) * 8)
        kw = {"renorm_every": (0, 1, 4)[(case + T) % 3],
              "io_dtype": ("f32", "bf16")[(case + T) % 2]}
        if variant == "masked":
            valid = np.ones((T, R), bool)
            valid[:T // 3] = valid[T - T // 3:] = False
            valid[:, ::5] = True
            kw.update(valid=torch.as_tensor(valid),
                      first=torch.as_tensor(rng.rand(R) < 0.5))
        elif variant == "boundary":
            kw["boundary"] = tuple(torch.as_tensor(
                rng.randn(S, R).astype(np.float32) * 3) for _ in range(2))
        want = BK.bcjr_appdiff_plain(
            syn, pan, li, _rsc(S), max_log=mode == "maxlog",
            lse="linear" if mode == "linear" else None, posterior=True, **kw)
        got = _lane_form_walk(syn, pan, li, _rsc(S), mode, **kw)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (T, kw)


# --------------------------------------------------------------------------
# K1: the ACS launch plan (kernels/viterbi_acs.py:acs_plan)
# --------------------------------------------------------------------------

from commpy_tpu_torch.kernels import viterbi_acs as VK  # noqa: E402

STATES = [2 ** k for k in range(1, 11)]


def _warp_lanes(S):
    """The warp kernel's index arithmetic (csrc/viterbi_acs.cu:
    acs_warp_kernel), lane by lane: (frame, low state, high state, lane of
    predecessor 2l, its half, lane of predecessor 2l+1, its half)."""
    W = S // 2
    rows = []
    for lane in range(32):
        g, l = lane // W, lane & (W - 1)
        rows.append((g, l, l + W, g * W + ((2 * l) & (W - 1)), 2 * l >= W,
                     g * W + ((2 * l + 1) & (W - 1)), 2 * l + 1 >= W))
    return rows


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("S", STATES)
def test_acs_plan_covers_every_state_once(S, n):
    for B in (1, 7, 2047):
        plan = VK.acs_plan(S, n, B)
        assert plan["lanes_per_frame"] * plan["states_per_lane"] == S
        if S <= 64:
            assert plan["layout"] == "warp"
            F = plan["frames_per_warp"]
            assert F * plan["lanes_per_frame"] == 32 and F * S == 64
            assert plan["warps_per_frame"] == 1
            assert plan["threads"] == 32 * plan["warps_per_block"] <= 128
            per_warp = plan["smem_bytes"] // plan["warps_per_block"]
            assert per_warp == 512 + 16 * -(-2 * F * (32 * n + 1) // 4)
            assert plan["smem_bytes"] <= (48 * 1024 if plan[
                "warps_per_block"] > 1 else K.SMEM_LIMIT)
            frames = plan["grid"] * plan["warps_per_block"] * F
            assert frames >= B > frames - plan["warps_per_block"] * F
            # each frame's lanes own every state once, and read their
            # predecessors 2l and 2l+1 from the lane and half that hold them
            lanes = _warp_lanes(S)
            for g in range(F):
                own = sorted(s for row in lanes if row[0] == g
                             for s in row[1:3])
                assert own == list(range(S))
            where = {(row[0], s): (lane, s == row[2])
                     for lane, row in enumerate(lanes) for s in row[1:3]}
            for g, l, _, la, ha, lb, hb in lanes:
                assert where[(g, 2 * l)] == (la, ha)
                assert where[(g, 2 * l + 1)] == (lb, hb)
        else:
            assert plan["layout"] == "block"
            assert plan["frames_per_warp"] == 1
            assert plan["warps_per_frame"] * 32 == S == plan["threads"]
            assert plan["grid"] == B
            assert plan["smem_bytes"] <= 48 * 1024


def test_acs_plan_at_the_mcs4_shape_and_its_limits():
    plan = VK.acs_plan(64, 2, 2048)
    # a warp a frame, four warps a block: 512 blocks of 128 threads
    assert (plan["layout"], plan["grid"], plan["threads"]) == ("warp", 512,
                                                              128)
    assert plan["smem_bytes"] == 4 * (512 + 16 * 33)
    # S = 2 at n = 8: one warp of 32 frames, its 66 KB opting in past 48 KB
    small = VK.acs_plan(2, 8, 33)
    assert (small["warps_per_block"], small["grid"]) == (1, 2)
    assert 48 * 1024 < small["smem_bytes"] <= K.SMEM_LIMIT
    for bad in ((3, 2), (2048, 2), (64, 9), (64, 0)):
        with pytest.raises(ValueError):
            VK.acs_plan(*bad, 8)


# --------------------------------------------------------------------------
# K2: the traceback launch plan (kernels/viterbi_acs.py:traceback_plan)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,tb,B", [
    (64, 1205, 30, 2048),   # MCS-4
    (64, 1029, 30, 2048),   # bench.py
    (2, 1, 2, 1), (2, 31, 3, 5), (4, 33, 30, 7), (1024, 100, 30, 3),
    (1024, 1784, 30, 2), (64, 300, 301, 3), (64, 300, 2000, 3),
    (64, 5000, 6000, 2), (1024, 3000, 3001, 2), (2, 58_200, 30, 2),
])
def test_traceback_plan_covers_every_frame_and_fits_a_block(S, T, tb, B):
    plan = VK.traceback_plan(S, T, tb, B)
    assert plan["D"] == min(tb, T + 1)
    # every frame once: a warp a frame, F frames a block
    F = plan["frames_per_block"]
    assert plan["threads"] == 32 * F and F in (1, 2, 4, 8)
    assert (plan["grid"] - 1) * F < B <= plan["grid"] * F
    # rows of staged decisions an odd number of words apart (1, or G + 1)
    G = -(-S // 32)
    assert plan["row"] == (1 if G == 1 else G + 1) and plan["row"] % 2
    frame = -(-4 * T * plan["row"] // 16) * 16
    assert plan["staged"] == (frame <= K.SMEM_LIMIT)
    assert plan["frame_bytes"] == (frame if plan["staged"] else 0)
    assert plan["smem_bytes"] == F * plan["frame_bytes"] <= K.SMEM_LIMIT
    # the frames an SM holds: its shared memory (1 KB a block besides),
    # 32 blocks and 64 warps
    blocks = plan["frames_per_sm"] // F
    assert blocks * (plan["smem_bytes"] + K.SMEM_PER_BLOCK) <= K.SM_SMEM
    assert 1 <= blocks <= 32 and blocks * F <= 64
    assert plan["waves"] == -(-B // (plan["frames_per_sm"] * 132))


def test_traceback_plan_puts_the_mcs4_shape_in_one_wave():
    plan = VK.traceback_plan(64, 1205, 30, 2048)
    # 14.5 KB of decisions a frame (rows of three words), eight frames a
    # block, two blocks an SM: 16 frames x 132 SMs >= 2048
    assert (plan["row"], plan["frame_bytes"]) == (3, 14_464)
    assert (plan["frames_per_block"], plan["frames_per_sm"]) == (8, 16)
    assert 2 * (plan["smem_bytes"] + K.SMEM_PER_BLOCK) == K.SM_SMEM
    assert plan["waves"] == 1 and plan["grid"] == 256
    assert VK.traceback_plan(64, 1029, 30, 2048)["waves"] == 1
    for bad in ((3, 10, 5), (2048, 10, 5), (64, 10, 1), (64, 0, 5)):
        with pytest.raises(ValueError):
            VK.traceback_plan(*bad, 4)


# --------------------------------------------------------------------------
# K4: the resident launch plan (kernels/qc_bp.py:resident_plan)
# --------------------------------------------------------------------------

RESIDENT = sorted(n for n, r in ROUTES.items() if r[0] == "resident")


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("name", RESIDENT)
def test_resident_plan_fits_a_block_and_an_sm(name, schedule):
    p = _code(name)
    g = _graph(p)
    n = g["Nb"] * g["Z"]
    plan = K.resident_plan(g["Z"], g["Nb"], g["Mb"], g["E"], g["kmax"],
                           schedule)
    assert plan["kmax_t"] in K.RESIDENT_KMAX and g["kmax"] <= plan["kmax_t"]
    assert plan["threads"] % 32 == 0
    assert plan["threads"] <= K.resident_max_threads(plan["kmax_t"],
                                                     schedule) <= 1024
    # a thread per check (flooding) or per circulant position (layered)
    work = g["Mb"] * g["Z"] if schedule == "flooding" else g["Z"]
    assert not plan["loop"] and work <= plan["threads"] < work + 32
    # shared memory: the frame's totals and messages, then the tables,
    # within a block's 227 KB and, with the block's 1 KB, an SM's
    assert plan["frame_bytes"] == 4 * (n + g["E"] * g["Z"])
    assert plan["table_bytes"] == 4 * (2 * g["E"] + g["Mb"] + g["Nb"])
    assert plan["smem_bytes"] == plan["frame_bytes"] + plan["table_bytes"]
    assert plan["smem_bytes"] <= K.SMEM_LIMIT == 232_448
    assert plan["smem_bytes"] + K.SMEM_PER_BLOCK <= K.SM_SMEM
    # the per-frame budget select_backend routes by holds the frame
    assert plan["frame_bytes"] <= K.resident_smem_bytes(n, g["Z"], g["E"])


def test_resident_plan_at_the_bench_code_and_past_a_block():
    g = _graph(_code("80211n-1944-1/2"))
    args = (g["Z"], g["Nb"], g["Mb"], g["E"], g["kmax"])
    # 972 checks: a block of 992 threads; 81 positions: 96
    assert K.resident_plan(*args, "flooding")["threads"] == 992
    assert K.resident_plan(*args, "layered")["threads"] == 96
    # rows of up to 32 blocks, and the layered rows, take 512-thread blocks
    g = _graph(_code("80211n-648-5/6"))
    assert K.resident_plan(g["Z"], g["Nb"], g["Mb"], g["E"], g["kmax"],
                           "flooding")["kmax_t"] == 32
    assert K.resident_max_threads(32, "flooding") == 512
    assert K.resident_max_threads(16, "flooding") == 1024
    assert K.resident_max_threads(8, "layered") == 512
    # past a block's threads each thread loops
    wide = K.resident_plan(640, 18, 2, 34, 17, "flooding")
    assert (wide["kmax_t"], wide["threads"], wide["loop"]) == (32, 512, True)
    assert K.resident_plan(640, 18, 2, 34, 17, "layered")["loop"]
    assert K.resident_plan(256, 12, 6, 24, 4, "flooding")["loop"]
    with pytest.raises(NotImplementedError, match="repeated column"):
        K.resident_plan(640, 18, 2, 34, 17, "layered", repeat=True)
    with pytest.raises(ValueError, match="too large for the resident"):
        g = _graph(_code("dvbs2-16200"))
        K.resident_plan(g["Z"], g["Nb"], g["Mb"], g["E"], g["kmax"],
                        "layered")
    with pytest.raises(ValueError, match="exceed"):
        K.resident_plan(8, 40, 1, 33, 33, "flooding")
    with pytest.raises(ValueError, match="schedule"):
        K.resident_plan(*args, "zigzag")


@pytest.mark.parametrize("name", ["80211n-1944-1/2", "80211n-648-5/6",
                                  "wimax-1440"])
def test_resident_column_tables_say_what_the_graph_says(name):
    g = _graph(_code(name))
    Z = g["Z"]
    col = g["col5"].astype(np.int64)
    cedge = g["cedge5"].astype(np.int64)
    assert np.array_equal(col & 0xFFFF, g["col_start"][:-1])
    assert np.array_equal(col >> 16, np.diff(g["col_start"]))
    assert np.array_equal(cedge >> 11, g["col_edges"] * Z)
    assert np.array_equal(cedge & 1023, g["es"][g["col_edges"]])
    # every edge once, each column's in row-major order
    assert sorted(g["col_edges"]) == list(range(g["E"]))
    for j in range(g["Nb"]):
        q0, D = col[j] & 0xFFFF, col[j] >> 16
        es = g["col_edges"][q0:q0 + D]
        assert list(es) == sorted(es) and all(g["ej"][es] == j)
