"""commpy_tpu_torch Viterbi decoder (the module holding kernels K1/K2).

Decoded bits must equal ``commpy_tpu.ops.viterbi.viterbi_decode_device``
on the CPU (its XLA scan, the f32 ground truth) for every decoding type,
S = 4, 64 and 256, odd batches, short and long traceback windows, +-inf
LLRs and the general (k = 2, recursive) path.  The plain versions of the
ACS and traceback kernels are also held against the JAX Pallas kernels,
run in interpret mode as tests/test_pallas_kernels.py runs them.
"""
import numpy as np
import pytest
import torch

from commpy_tpu.kernels import viterbi_acs as JK
from commpy_tpu.ops.convcode import encode_scan as jencode
from commpy_tpu.ops.trellis import Trellis as JTrellis
from commpy_tpu.ops.viterbi import viterbi_decode as jdecode
from commpy_tpu.ops.viterbi import viterbi_decode_device as jdecode_device
from commpy_tpu_torch.kernels import viterbi_acs as K
from commpy_tpu_torch.ops import viterbi as V
from commpy_tpu_torch.ops.trellis import Trellis

torch.set_num_threads(1)

CODES = {
    "S4": (np.array([2]), np.array([[5, 7]])),
    "S64": (np.array([6]), np.array([[0o133, 0o171]])),
    "S256": (np.array([8]), np.array([[0o561, 0o753]])),
    "k2": (np.array([2, 1]), np.array([[5, 7, 0], [0, 2, 3]])),
    "rsc": (np.array([2]), np.array([[1, 7]]), 5, "rsc"),
}


def _received(code, decoding_type, B, L, seed):
    """Same NumPy draws for both packages: a random message through the
    code and a noisy channel matching the decoding type."""
    jt = JTrellis(*CODES[code])
    rng = np.random.RandomState(seed)
    msg = rng.randint(0, 2, (B, L))
    coded = np.asarray(jencode(msg, jt)[0]).astype(np.float64)
    if decoding_type == "hard":
        flips = rng.rand(*coded.shape) < 0.05
        x = np.where(flips, 1 - coded, coded)
    elif decoding_type == "soft":
        x = (2 * coded - 1) * 2.0 + rng.randn(*coded.shape) * 1.6
    else:
        x = (2 * coded - 1) + rng.randn(*coded.shape) * 0.8
    return jt, Trellis(*CODES[code]), msg, x.astype(np.float32)


# (code, decoding type, B, L, tb_depth)
CASES = [
    ("S4", "hard", 5, 120, 15),
    ("S4", "soft", 5, 120, 15),
    ("S4", "unquantized", 5, 120, 15),
    ("S64", "hard", 3, 150, 20),
    ("S64", "soft", 3, 150, 20),
    ("S64", "unquantized", 3, 150, 20),
    ("S64", "soft", 7, 150, 2),
    ("S64", "soft", 2, 60, 200),  # window longer than the frame
    ("S256", "soft", 3, 100, 40),
    ("S256", "hard", 3, 100, 40),
    ("k2", "hard", 3, 90, 15),
    ("k2", "soft", 3, 90, 15),
    ("rsc", "soft", 3, 90, 15),
]


@pytest.mark.parametrize("code,decoding_type,B,L,tb", CASES)
def test_decode_matches_jax(code, decoding_type, B, L, tb):
    jt, pt, msg, x = _received(code, decoding_type, B, L, seed=B * L + tb)
    want = np.asarray(jdecode_device(x, jt, tb, decoding_type))
    got = V.viterbi_decode_device(torch.as_tensor(x), pt, tb, decoding_type,
                                  device="cpu")
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the decoder does real work at these noise levels
    assert (got.numpy() != msg[:, : got.shape[1]]).mean() < 0.4


@pytest.mark.parametrize("code", ["S4", "S64"])
def test_decode_inf_llrs(code):
    jt, pt, msg, x = _received(code, "soft", 2, 80, seed=3)
    x = np.sign(x) * np.inf
    x[0, :6] = 0.0
    want = np.asarray(jdecode_device(x, jt, 15, "soft"))
    got = V.viterbi_decode_device(x, pt, 15, "soft", device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_batch_shape_and_unbatched():
    jt, pt, msg, x = _received("S4", "soft", 6, 40, seed=5)
    x3 = x.reshape(2, 3, -1)
    got = V.viterbi_decode_device(x3, pt, 10, "soft", L=40, device="cpu")
    assert tuple(got.shape) == (2, 3, 40)
    np.testing.assert_array_equal(got.reshape(6, 40).numpy(),
                                  np.asarray(jdecode_device(x, jt, 10,
                                                            "soft", L=40)))
    one = V.viterbi_decode_device(x[1], pt, 10, "soft", L=40, device="cpu")
    np.testing.assert_array_equal(one.numpy(), got.reshape(6, 40)[1].numpy())
    # the reference-compatible host wrapper and the decoder closure
    np.testing.assert_array_equal(
        V.viterbi_decode(x[1], pt, 10, "soft", device="cpu"),
        jdecode(x[1], jt, 10, "soft"))
    dec = V.make_viterbi_decoder(pt, 10, "soft", 40, device="cpu")
    np.testing.assert_array_equal(dec(torch.as_tensor(x)).numpy(),
                                  got.reshape(6, 40).numpy())


def test_plain_kernels_match_pallas_interpret():
    # B=4, L=300, K=7: the shape of tests/test_pallas_kernels.py
    jt, pt, msg, x = _received("S64", "soft", 4, 300, seed=0)
    r = V.received_words(torch.as_tensor(x), pt, "soft", 300)
    jdec, jbest = JK.acs_forward_pallas(r.numpy(), jt, "soft", layout="btg")
    C, hc = V._kernel_tables(V._branch_vectors(pt, "soft"), pt, "soft",
                             torch.device("cpu"))
    dec, best = K.acs_forward_plain(r, C, hc)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    jbits = JK.traceback_pallas(jdec, jbest, 64, 20)
    bits = K.traceback_plain(dec, best, 64, 20)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))


def test_plain_kernels_hard_metric_and_packing():
    # hard metric with its per-branch constant, S=256 (8 words, bit 31 set)
    jt, pt, msg, x = _received("S256", "hard", 2, 60, seed=9)
    want = np.asarray(jdecode_device(x, jt, 12, "hard"))
    r = V.received_words(torch.as_tensor(x), pt, "hard", 60)
    C, hc = V._kernel_tables(V._branch_vectors(pt, "hard"), pt, "hard",
                             torch.device("cpu"))
    dec, best = K.acs_forward(r, C, hc)
    assert dec.shape == (2, 60 + 8 - 1, 8) and dec.dtype == torch.int32
    assert bool((dec < 0).any())  # state 31 of some word took branch 1
    bits = K.traceback(dec, best, 256, 12)
    np.testing.assert_array_equal(bits[:, :60].numpy(), want)


def test_cpu_tensors_take_the_plain_path_without_launching():
    before = (K.acs_forward.launches, K.traceback.launches)
    jt, pt, msg, x = _received("S64", "soft", 2, 40, seed=1)
    a = V.viterbi_decode_device(x, pt, 10, "soft", backend="auto",
                                device="cpu")
    b = V.viterbi_decode_device(x, pt, 10, "soft", backend="torch",
                                device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (K.acs_forward.launches, K.traceback.launches) == before


def test_auto_sends_every_shift_trellis_to_the_kernels(monkeypatch):
    # every shift trellis the kernels take goes to them on either device;
    # S = 2048 (K = 12) is past the CUDA ACS kernel's limit, so 'auto'
    # takes the general path there, as it does for any trellis K1/K2 do
    # not take, and 'cuda' raises with the limit
    for code in ("S4", "S64", "S256"):
        for device_type in ("cpu", "cuda"):
            assert V.viterbi_route(Trellis(*CODES[code]), "auto",
                                   device_type) == "kernels"
    pt = Trellis(np.array([11]), np.array([[0o4335, 0o5723]]))
    assert pt.number_states == 2048 and V._is_shift_structured(pt)
    for device_type in ("cpu", "cuda"):
        assert V.viterbi_route(pt, "auto", device_type) == "general"
        assert V.viterbi_route(Trellis(*CODES["k2"]), "auto",
                               device_type) == "general"
    assert V.viterbi_route(pt, "torch", "cpu") == "plain"
    with pytest.raises(NotImplementedError, match="at most 1024 states"):
        V.viterbi_route(pt, "cuda", "cuda")

    def kernels(*args):
        raise AssertionError("the kernels' route was taken")

    monkeypatch.setattr(V, "acs_forward", kernels)
    x = np.random.RandomState(2).randn(2, 2 * 24).astype(np.float32)
    got = V.viterbi_decode_device(x, pt, 12, "soft", device="cpu")
    want = V.viterbi_decode_device(x, pt, 12, "soft", backend="torch",
                                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(AssertionError, match="kernels' route"):
        V.viterbi_decode_device(x, Trellis(*CODES["S64"]), 12, "soft",
                                device="cpu")


@pytest.mark.parametrize("decoding_type", ["soft", "hard"])
def test_k12_code_decodes_like_jax(decoding_type):
    # K = 12 (S = 2048): 'auto' decodes it (the general path) to the JAX
    # package's bits
    gens = (np.array([11]), np.array([[0o4335, 0o5723]]))
    jt, pt = JTrellis(*gens), Trellis(*gens)
    rng = np.random.RandomState(31)
    msg = rng.randint(0, 2, (3, 40))
    coded = np.asarray(jencode(msg, jt)[0]).astype(np.float64)
    if decoding_type == "soft":
        x = (2 * coded - 1) * 2.0 + rng.randn(*coded.shape) * 1.2
    else:
        x = np.where(rng.rand(*coded.shape) < 0.03, 1 - coded, coded)
    x = x.astype(np.float32)
    want = np.asarray(jdecode_device(x, jt, 30, decoding_type, L=40))
    got = V.viterbi_decode_device(x, pt, 30, decoding_type, L=40,
                                  device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != msg).mean() < 0.05


def test_shift_structure_detection():
    assert V._is_shift_structured(Trellis(*CODES["S64"]))
    # recursive: predecessors are shift-structured but the input bit is
    # not the state's MSB, so the kernels' traceback would be wrong
    rsc = Trellis(*CODES["rsc"])
    assert not V._is_shift_structured(rsc)
    assert not V._is_shift_structured(Trellis(*CODES["k2"]))


def test_argument_errors():
    pt = Trellis(*CODES["S4"])
    x = torch.zeros(2, 40)
    with pytest.raises(ValueError, match="decoding types"):
        V.viterbi_decode_device(x, pt, 10, "bogus", device="cpu")
    with pytest.raises(ValueError, match="tb_depth"):
        V.viterbi_decode_device(x, pt, 1, "soft", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        V.viterbi_decode_device(x, pt, 10, "soft", backend="pallas",
                                device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        V.viterbi_decode_device(x, pt, 10, "soft", backend="cuda",
                                device="cpu")
    with pytest.raises(ValueError, match="float32"):
        K.acs_forward(x.reshape(2, 20, 2).double(), torch.zeros(2, 4, 2))
    with pytest.raises(ValueError, match="power of 2"):
        K.acs_forward(x.reshape(2, 20, 2), torch.zeros(2, 6, 2))
    with pytest.raises(ValueError, match="int32"):
        K.traceback(torch.zeros(2, 20, 1), torch.zeros(2, 20,
                                                       dtype=torch.int32),
                    4, 5)


@pytest.mark.parametrize("kind", ["zero", "negzero"])
@pytest.mark.parametrize("decoding_type", ["soft", "hard", "unquantized"])
def test_ties_and_signed_zeros_match_jax(decoding_type, kind):
    # r = 0 makes every step a tie between the two branches of every state
    # and between states; -0.0 received values must not tip any of them
    jt, pt = JTrellis(*CODES["S64"]), Trellis(*CODES["S64"])
    B, L = 3, 70
    if kind == "zero":
        x = np.zeros((B, 2 * L), np.float32)
    else:
        x = (np.random.RandomState(4).randn(B, 2 * L) * 2).astype(np.float32)
        x[:, ::3] = -0.0
        x[1] = -0.0
    r = V.received_words(torch.as_tensor(x), pt, decoding_type, L)
    C, hc = V._kernel_tables(V._branch_vectors(pt, decoding_type), pt,
                             decoding_type, torch.device("cpu"))
    dec, best = K.acs_forward_plain(r, C, hc)
    jdec, jbest = JK.acs_forward_pallas(r.numpy(), jt, decoding_type,
                                        layout="btg")
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    bits = K.traceback_plain(dec, best, 64, 20)[:, :L].numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(jdecode_device(x, jt, 20, decoding_type)))
    np.testing.assert_array_equal(
        bits, np.asarray(JK.traceback_pallas(jdec, jbest, 64, 20))[:, :L])
    if kind == "zero":
        # all-tie: the first state wins every step, so every bit is 0
        assert not bits.any() and not best.numpy().any()


def _key(x):
    """The ACS kernel's order-preserving 32-bit key of float32 ``x``."""
    b = x.view(np.uint32)
    return np.where(b >> 31, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def _unkey(k):
    return np.where(k >> 31, k & np.uint32(0x7FFFFFFF),
                    ~k).astype(np.uint32).view(np.float32)


def _kernel_argmin(v):
    """The ACS kernel's minimum rule on one step's metrics ``v`` [S]: the
    least key over the states, back to a float, then the first state whose
    metric equals it as a float (``csrc/viterbi_acs.cu``)."""
    m = _unkey(np.array([_key(v).min()], np.uint32))[0]
    return int(np.flatnonzero(v == m)[0]), m


@pytest.mark.parametrize("values", [
    [3.0, 1.0, 1.0, 2.0],            # a tie: the first wins
    [0.0, -0.0, 5.0, 1.0],           # +0.0 before -0.0
    [-0.0, 0.0, 5.0],                # -0.0 before +0.0
    [2.0, 0.0, -0.0, 0.0, 7.0],
    [-1.5, 3.0e37, -1.5, -2.5e-38],  # negatives, denormal-sized, unreached
    [3.0e37] * 6,
])
def test_kernel_minimum_rule_matches_torch_argmin(values):
    v = np.array(values, np.float32)
    idx, m = _kernel_argmin(v)
    assert idx == int(torch.argmin(torch.as_tensor(v)))
    assert m == float(torch.amin(torch.as_tensor(v)))


def test_kernel_minimum_rule_on_random_ties():
    rng = np.random.RandomState(7)
    for _ in range(300):
        v = rng.choice(np.array([-2.0, -0.0, 0.0, 1.0, 4.0], np.float32),
                       size=rng.randint(2, 65))
        assert _kernel_argmin(v)[0] == int(torch.argmin(torch.as_tensor(v)))
        # the key order is the float order, -0.0 below +0.0
        k = _key(v)
        for a, b in zip(k[:-1], k[1:]):
            x, y = _unkey(np.array([a]))[0], _unkey(np.array([b]))[0]
            assert (a < b) == (x < y or (x == y == 0 and np.signbit(x)
                                         and not np.signbit(y)))
