"""The traceback's walks, held on the CPU.

``traceback_merge_plain`` is the merge-aware walk: each lane walks a new
window back only until it meets its previous path, and counts its
back-steps (``chip_smoke.py`` reports them beside K2's).  It must equal
``traceback_plain`` (every window walked in full, the reference schedule)
bit for bit on decisions of random words, on decisions of real encoded
frames, on all-tie inputs, at tb_depth 2, 3 and past T, at S = 2 to
1024, and with lane counts that do not divide T; and equal the JAX
package's Pallas traceback, run in interpret mode.

``_k2_model`` is K2's own walk (``csrc/viterbi_acs.cu:traceback_kernel``),
which has no other model off the card: the state as a 32-bit shift
register, each decision word picked five steps ahead, the walk stopping
log2(S) - 1 steps early.  It must equal ``traceback_plain`` too.
"""
import numpy as np
import pytest
import torch

from commpy_tpu.kernels import viterbi_acs as JK
from commpy_tpu_torch.kernels import viterbi_acs as K
from commpy_tpu_torch.ops import viterbi as V
from commpy_tpu_torch.ops.convcode import encode_scan
from commpy_tpu_torch.ops.trellis import Trellis

torch.set_num_threads(1)


def _random(S, B, T, seed):
    g = torch.Generator().manual_seed(seed)
    dec = torch.randint(-2 ** 31, 2 ** 31, (B, T, -(-S // 32)),
                        dtype=torch.int64, generator=g).to(torch.int32)
    best = torch.randint(0, S, (B, T), generator=g).to(torch.int32)
    return dec, best


def _same(dec, best, S, tb, lanes):
    """The two walks' bits are equal; returns the merge walk's back-steps,
    which never exceed the full walks' (no walk passes its window)."""
    want = K.traceback_plain(dec, best, S, tb)
    got, steps = K.traceback_merge_plain(dec, best, S, tb, lanes)
    assert torch.equal(got, want), (S, tuple(dec.shape), tb, lanes)
    assert steps.shape == (dec.shape[0], lanes)
    T = dec.shape[1]
    full = np.minimum(min(tb, T + 1) - 2, T - 1 - np.arange(T)).clip(min=0)
    assert int(steps.sum(1).max()) <= int(full.sum())
    # the ring holds a window's states, at most T, in a power of two
    R = K._tb_ring(T, tb)
    assert min(tb, T + 1) - 1 <= R < 2 * max(min(tb, T + 1) - 1, 1)
    assert R & (R - 1) == 0
    return steps


@pytest.mark.parametrize("S", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024])
def test_merge_walk_equals_full_walks_on_random_words(S):
    # random words: paths rarely merge; T of 1 up, lane counts that do not
    # divide T, tb_depth 2, 3, below, at and past T
    for T in (1, 5, 31, 33, 77):
        for tb in (2, 3, 30, T, T + 1, T + 7):
            if tb < 2:
                continue
            dec, best = _random(S, 2, T, seed=S * 1000 + T * 10 + tb)
            for lanes in (32, 7):
                steps = _same(dec, best, S, tb, lanes)
                if tb == 2:  # a window of one state: nothing to walk
                    assert not steps.any()


@pytest.mark.parametrize("S", [2, 64, 1024])
def test_merge_walk_on_all_ties(S):
    # every decision 0 and every best state 0: one path of state 0
    for T, tb in ((40, 30), (40, 41), (7, 2)):
        dec = torch.zeros((3, T, -(-S // 32)), dtype=torch.int32)
        best = torch.zeros((3, T), dtype=torch.int32)
        steps = _same(dec, best, S, tb, 32)
        # a lane walks its first window, then each new path meets the last
        # one a step below its window's end
        run = K._tb_run(T, 32)
        assert int(steps.max()) <= min(tb, T + 1) - 2 + run - 1
        # all ones, and best states at the top state: the MSB path
        dec = torch.full_like(dec, -1)
        best = torch.full_like(best, S - 1)
        _same(dec, best, S, tb, 5)


@pytest.mark.parametrize("code,dtype,B,L,tb", [
    ((np.array([6]), np.array([[0o133, 0o171]])), "soft", 3, 150, 30),
    ((np.array([6]), np.array([[0o133, 0o171]])), "soft", 2, 60, 200),
    ((np.array([8]), np.array([[0o561, 0o753]])), "hard", 2, 90, 40),
    ((np.array([2]), np.array([[5, 7]])), "unquantized", 5, 101, 15),
])
def test_merge_walk_on_encoded_frames(code, dtype, B, L, tb):
    pt = Trellis(*code)
    rng = np.random.RandomState(L)
    coded = encode_scan(rng.randint(0, 2, (B, L)), pt, device="cpu")[0]
    coded = coded.numpy().astype(np.float32)
    if dtype == "hard":
        x = np.where(rng.rand(*coded.shape) < 0.05, 1 - coded, coded)
    else:
        x = (2 * coded - 1) * 2.0 + rng.randn(*coded.shape) * 1.2
    r = V.received_words(torch.as_tensor(x.astype(np.float32)), pt, dtype,
                         L)
    C, hc = V._kernel_tables(V._branch_vectors(pt, dtype), pt, dtype,
                             torch.device("cpu"))
    dec, best = K.acs_forward_plain(r, C, hc)
    S = pt.number_states
    for lanes in (32, 6):
        steps = _same(dec, best, S, tb, lanes)
    # on a real frame the paths merge within a few steps: far fewer
    # back-steps than walking every window in full
    T = dec.shape[1]
    full = np.minimum(min(tb, T + 1) - 2, T - 1 - np.arange(T)).clip(
        min=0).sum()
    assert float(steps.sum(1).float().mean()) < full / 2


def test_merge_walk_equals_pallas_interpret():
    dec, best = _random(64, 4, 130, seed=5)
    jbits = JK.traceback_pallas(dec.numpy(), best.numpy(), 64, 20,
                                layout="btg")
    bits, _ = K.traceback_merge_plain(dec, best, 64, 20)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))


def _k2_model(dec, best, S, tb_depth):
    """K2's walk in plain PyTorch, a position a column: from the window's
    end w = min(p + D - 2, T - 1) it takes n = w - p - e back-steps, e =
    min(w - p, log2(S) - 1), keeping the state as an unmasked 32-bit
    shift register r (r' = (r << 1) | bit), and emits bit log2(S) - 1 - e
    of r.  Step k reads its word at time w - k by the register five steps
    earlier (for k < 5, the window end's register shifted right by 5 - k),
    its bit by r & 31 (by r & (S - 1) below 32 states); reads below time 0
    read time 0, as the kernel's first rows do."""
    B, T, G = dec.shape
    D = min(tb_depth, T + 1)
    msb = max(S.bit_length() - 2, 0)
    words = dec.long() & 0xFFFFFFFF
    bidx = torch.arange(B)[:, None]
    p = torch.arange(T)
    w = torch.clamp(p + D - 2, max=T - 1)
    e = torch.clamp(w - p, max=msb)
    n = (w - p - e).clamp(min=0)
    r = best[:, w].long()
    hist = [r]  # the register after each step
    for k in range(int(n.max()) if T else 0):
        ahead = hist[k - 5] if k >= 5 else hist[0] >> (5 - k)
        t = (w - k).clamp(min=0)
        word = words[bidx, t, ahead & (G - 1)]
        sh = r & (S - 1) if S < 32 else r & 31
        nxt = ((r << 1) | ((word >> sh) & 1)) & 0xFFFFFFFF
        r = torch.where(k < n, nxt, r)
        hist.append(r)
    return ((r >> (msb - e)) & 1).to(torch.int8)


@pytest.mark.parametrize("S", [2, 4, 8, 16, 32, 64, 128, 256, 1024])
def test_k2_walk_equals_full_walks(S):
    # random words, all ties and all ones; T of 1 up; tb_depth 2, 3, below,
    # at and past T
    for T in (1, 6, 33, 70):
        for tb in (2, 3, 30, T, T + 1, T + 7):
            if tb < 2:
                continue
            dec, best = _random(S, 2, T, seed=S * 997 + T * 13 + tb)
            for d in (dec, torch.zeros_like(dec), torch.full_like(dec, -1)):
                want = K.traceback_plain(d, best, S, tb)
                assert torch.equal(_k2_model(d, best, S, tb), want), (S, T,
                                                                      tb)
