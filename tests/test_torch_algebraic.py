"""The port's algebraic codes against the JAX package, bit for bit.

GF(2^m) element algebra and cyclic-code generator polynomials (host
NumPy in both packages), the bit-sliced GF(2^m) toolbox, BCH and RS
encoders and decoders (every ``(corrected, n_err, ok)``: 0 to t+2 errors
at m = 4, 5, 6 for BCH with both locators at t = 2, shortened and not;
hard, errata and GMD decoding at m = 4 and 8 with fcr 0 and 1 for RS),
CRC tables, attach and check for every CRC but crc24c, Chase decoding,
and turbo product codes.  The goldens ``tests/bch_ref.py`` and
``tests/rs_ref.py`` are a second reference.  The Chase soft outputs are
float32 sums and are held within 1e-5 x (1 + |x|), with identical
decisions.  The one GF(2^16) t = 12 case is the DVB-S2 link's outer code,
in ``tests/test_torch_dsp_code_links.py``.

CRC24C is the exception: the port follows 3GPP TS 38.212 (0xB2B117,
catalog check 0xF48279) where the JAX package's polynomial gives
0xBE7F82.
"""
import binascii
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bch_ref
import rs_ref
from commpy_tpu.ops import algebraic as JA
from commpy_tpu.ops import bch as JB
from commpy_tpu.ops import crc as JC
from commpy_tpu.ops import galois as JG
from commpy_tpu.ops import gf2m as JGF
from commpy_tpu.ops import rs as JR
from commpy_tpu.ops import tpc as JT
from commpy_tpu_torch import convert
from commpy_tpu_torch.ops import algebraic as PA
from commpy_tpu_torch.ops import bch as PB
from commpy_tpu_torch.ops import crc as PC
from commpy_tpu_torch.ops import galois as PG
from commpy_tpu_torch.ops import gf2m as PGF
from commpy_tpu_torch.ops import rs as PR
from commpy_tpu_torch.ops import tpc as PT

torch.set_num_threads(1)


def _np(outs):
    return [np.asarray(o) for o in outs]


def _same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------- GF, cyclic

@pytest.mark.parametrize("m", [3, 4, 6])
def test_gf_element_algebra_identical(m):
    rng = np.random.default_rng(m)
    x = rng.integers(0, 2 ** m, 2 ** m)
    y = rng.permutation(2 ** m)
    for P, J in ((PG.GF(x, m), JG.GF(x, m)), (PG.GF(y, m), JG.GF(y, m))):
        np.testing.assert_array_equal(P.elements, J.elements)
    np.testing.assert_array_equal((PG.GF(x, m) + PG.GF(y, m)).elements,
                                  (JG.GF(x, m) + JG.GF(y, m)).elements)
    np.testing.assert_array_equal((PG.GF(x, m) * PG.GF(y, m)).elements,
                                  (JG.GF(x, m) * JG.GF(y, m)).elements)
    nz = np.arange(1, 2 ** m)
    for name in ("power_to_tuple", "tuple_to_power"):
        a = getattr(PG.GF(nz if name == "tuple_to_power" else nz - 1, m),
                    name)()
        b = getattr(JG.GF(nz if name == "tuple_to_power" else nz - 1, m),
                    name)()
        np.testing.assert_array_equal(a.elements, b.elements)
    np.testing.assert_array_equal(PG.GF(nz, m).order(), JG.GF(nz, m).order())
    for a, b in zip(PG.GF(np.arange(2 ** m), m).cosets(),
                    JG.GF(np.arange(2 ** m), m).cosets()):
        np.testing.assert_array_equal(a.elements, b.elements)
    np.testing.assert_array_equal(PG.GF(np.arange(2 ** m), m).minpolys(),
                                  JG.GF(np.arange(2 ** m), m).minpolys())
    assert PG.polydivide(0b1011011, 0b1011) == JG.polydivide(0b1011011, 0b1011)
    assert PG.poly_to_string(19) == JG.poly_to_string(19)
    # the reference's goldens (tests/test_gf_algcode.py)
    if m == 4:
        np.testing.assert_array_equal(
            PG.GF(np.arange(2 ** m), m).minpolys(),
            [2, 3, 19, 19, 19, 19, 7, 7, 31, 25, 31, 25, 31, 25, 25, 31])


@pytest.mark.parametrize("n,k", [(7, 4), (15, 4), (15, 7), (31, 21)])
def test_cyclic_code_genpoly_identical(n, k):
    np.testing.assert_array_equal(PA.cyclic_code_genpoly(n, k),
                                  JA.cyclic_code_genpoly(n, k))
    with pytest.raises(ValueError):
        PA.cyclic_code_genpoly(16, 4)


# -------------------------------------------------------------- gf2m toolbox

@pytest.mark.parametrize("m", [3, 4, 5, 8])
def test_gf2m_tables_identical(m):
    for a, b in zip(PGF.gf_tables(m), JGF.gf_tables(m)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PGF.gf_reduce_matrix(m),
                                  JGF.gf_reduce_matrix(m))
    np.testing.assert_array_equal(PGF.gf_square_matrix(m),
                                  JGF.gf_square_matrix(m))
    for c in (0, 1, 2, (1 << m) - 1, 5 % (1 << m)):
        np.testing.assert_array_equal(PGF.gf_constant_mult_matrix(c, m),
                                      JGF.gf_constant_mult_matrix(c, m))
    size = (1 << m) - 1
    for deg, block, exps in ((2, 7, None), (3, size, None),
                             (3, 4, [-1, 0, 1, 2])):
        for a, b in zip(PGF.chien_tables(m, deg, size, block, exps),
                        JGF.chien_tables(m, deg, size, block, exps)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m", [4, 5])
def test_conv_xor_and_inverse_on_every_pair(m):
    exp, log = PGF.gf_tables(m)
    q = 1 << m
    a, b = np.meshgrid(np.arange(q), np.arange(q), indexing="ij")
    a, b = a.ravel(), b.ravel()
    bits = lambda v: ((v[:, None] >> np.arange(m)) & 1).astype(np.float32)
    R = PGF.gf_reduce_matrix(m).astype(np.float32)
    S = PGF.gf_square_matrix(m).astype(np.float32)
    got = PGF.conv_xor(torch.as_tensor(bits(a)), torch.as_tensor(bits(b)), m,
                       torch.as_tensor(R)).numpy()
    want = np.asarray(JGF.conv_xor(jnp.asarray(bits(a)),
                                   jnp.asarray(bits(b)), m, jnp.asarray(R)))
    np.testing.assert_array_equal(got, want)
    prod = np.where((a == 0) | (b == 0), 0,
                    exp[(log[a] + log[b]) % (q - 1)])
    np.testing.assert_array_equal(got, bits(prod))
    x = np.arange(q)
    inv = PGF.gf_inverse_bits(torch.as_tensor(bits(x)), m, torch.as_tensor(S),
                              torch.as_tensor(R)).numpy()
    np.testing.assert_array_equal(inv, np.asarray(JGF.gf_inverse_bits(
        jnp.asarray(bits(x)), m, jnp.asarray(S), jnp.asarray(R))))
    want_inv = np.where(x == 0, 0, exp[(q - 1 - log[x]) % (q - 1)])
    np.testing.assert_array_equal(inv, bits(want_inv))


# ------------------------------------------------------------------------ BCH

BCH_CASES = [(4, 2, 0), (5, 2, 3), (5, 3, 0), (6, 2, 0), (6, 3, 13)]


def _bch_words(code, seed, reps=3):
    """Codewords with 0 .. t+2 errors (``reps`` words each), the errors at
    distinct random positions."""
    rng = np.random.default_rng(seed)
    B = reps * (code.t + 3)
    msg = rng.integers(0, 2, (B, code.k))
    cw = np.asarray(JB.bch_encode(code, msg))
    rx = cw.copy()
    for b in range(B):
        rx[b, rng.choice(code.n, b % (code.t + 3), replace=False)] ^= 1
    return msg, cw, rx


@pytest.mark.parametrize("m,t,shorten", BCH_CASES)
def test_bch_code_encode_and_decode_identical(m, t, shorten):
    jc, pc = JB.bch_construct(m, t, shorten), PB.bch_construct(m, t, shorten)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    np.testing.assert_array_equal(PB.bch_genpoly(m, t), JB.bch_genpoly(m, t))
    msg, cw, rx = _bch_words(jc, m * 100 + t)
    got = PB.bch_encode(pc, msg, device="cpu")
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), cw)
    for locator in ("bm", "quad") if t == 2 else ("bm", "auto"):
        want = _np(JB.make_bch_decoder(jc, locator=locator)(jnp.asarray(rx)))
        outs = PB.make_bch_decoder(pc, locator=locator, device="cpu")(rx)
        assert [o.dtype for o in outs] == [torch.int8, torch.int32,
                                           torch.bool]
        _same(outs, want)
        # within t every word is corrected; the golden agrees throughout
        n_err = np.arange(len(rx)) % (t + 3)
        assert want[2][n_err <= t].all()
        np.testing.assert_array_equal(want[0][n_err <= t], cw[n_err <= t])
        for b in range(len(rx)):
            c, ne, ok = bch_ref.decode_np(rx[b], m, t, jc.n)
            if ok:
                assert want[2][b] and np.array_equal(want[0][b], c)
    # syndromes -> Berlekamp-Massey locators, as the decoder forms them
    S = PB._syndrome_table(pc).astype(np.float32)
    synd = ((rx @ S) % 2).reshape(len(rx), 2 * t, m).astype(np.float32)
    R = PGF.gf_reduce_matrix(m).astype(np.float32)
    _same(PGF.bm_inversionless(torch.as_tensor(synd), t, m,
                               torch.as_tensor(R)),
          _np(JGF.bm_inversionless(jnp.asarray(synd), t, m, jnp.asarray(R))))
    with pytest.raises(ValueError):
        PB.make_bch_decoder(pc, locator="qr", device="cpu")


def test_bch_chase_decoders_identical():
    code = JB.bch_construct(5, 2)
    pc = PB.bch_construct(5, 2)
    rng = np.random.default_rng(7)
    msg, cw, rx = _bch_words(code, 8, reps=6)
    rel = rng.random(rx.shape).astype(np.float32)
    # the flipped bits among the least reliable: beyond-t words decode
    rel[rx != cw] *= 0.1
    want = _np(JB.bch_chase_decode(code, rx, rel))
    _same(PB.bch_chase_decode(pc, rx, rel, device="cpu"), want)
    assert want[2][(rx != cw).sum(-1) <= 3].all()
    # uniform reliabilities: integer scores, ties to the first pattern
    ones = np.ones(rx.shape, np.float32)
    _same(PB.bch_chase_decode(pc, rx, ones, device="cpu"),
          _np(JB.bch_chase_decode(code, rx, ones)))
    # soft-output Chase (positive LLR => bit 0)
    llr = ((1.0 - 2.0 * cw) * 2.0 + rng.normal(0, 1.2, cw.shape)).astype(
        np.float32)
    sj, hj = _np(JB.make_bch_chase_soft(code)(jnp.asarray(llr)))
    sp, hp = PB.make_bch_chase_soft(pc, device="cpu")(llr)
    np.testing.assert_array_equal(hp.numpy(), hj)
    assert np.all(np.abs(sp.numpy() - sj) <= 1e-5 * (1 + np.abs(sj)))


# ------------------------------------------------------------------------- RS

RS_CASES = [(4, 2, 0, 1), (4, 3, 2, 0), (8, 4, 0, 0), (8, 3, 50, 1)]


@pytest.mark.parametrize("m,t,shorten,fcr", RS_CASES)
def test_rs_code_encode_and_decoders_identical(m, t, shorten, fcr):
    jc = JR.rs_construct(m, t, shorten, fcr)
    pc = PR.rs_construct(m, t, shorten, fcr)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    rng = np.random.default_rng(m * 100 + t * 10 + fcr)
    B = 3 * (t + 3)
    msg = rng.integers(0, 1 << m, (B, jc.k))
    cw = np.asarray(JR.rs_encode(jc, msg))
    got = PR.rs_encode(pc, msg, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), cw)
    rx = cw.copy()
    for b in range(B):
        pos = rng.choice(jc.n, b % (t + 3), replace=False)
        rx[b, pos] ^= rng.integers(1, 1 << m, len(pos))
    want = _np(JR.rs_decode(jc, rx))
    _same(PR.rs_decode(pc, rx, device="cpu"), want)
    n_err = np.arange(B) % (t + 3)
    np.testing.assert_array_equal(want[0][n_err <= t], cw[n_err <= t])
    for b in range(B):
        c, _, ok = rs_ref.decode_np(rx[b], m, t, jc.n, fcr)
        assert ok == want[2][b] and np.array_equal(c, want[0][b])
    # errors and erasures: some erasures on error positions, some not
    mask = rng.random(rx.shape) < 1.5 / jc.n
    mask |= (rx != cw) & (rng.random(rx.shape) < 0.5)
    _same(PR.rs_errata_decode(pc, rx, mask, device="cpu"),
          _np(JR.rs_errata_decode(jc, rx, mask)))
    # GMD: the errors among the least reliable symbols
    rel = rng.random(rx.shape).astype(np.float32)
    rel[rx != cw] *= 0.2
    want = _np(JR.rs_gmd_decode(jc, rx, rel))
    _same(PR.rs_gmd_decode(pc, rx, rel, device="cpu"), want)
    assert want[2][n_err <= t].all()


# ------------------------------------------------------------------------ CRC

CHECK_BITS = np.unpackbits(np.frombuffer(b"123456789", np.uint8))


def _as_int(rem):
    return int("".join(str(int(b)) for b in rem), 2)


@pytest.mark.parametrize("name", sorted(set(PC.CRC_POLYNOMIALS) - {"crc24c"}))
def test_crc_identical_to_jax(name):
    assert PC.CRC_POLYNOMIALS[name] == JC.CRC_POLYNOMIALS[name]
    rng = np.random.default_rng(len(name))
    for init, xorout in ((0, 0), (0x35, 0x11)):
        ps = PC.CrcSpec(PC.CRC_POLYNOMIALS[name], init, xorout)
        js = JC.CrcSpec(JC.CRC_POLYNOMIALS[name], init, xorout)
        for k in (1, 45, 300):
            for a, b in zip(PC.crc_tables(ps, k), JC.crc_tables(js, k)):
                np.testing.assert_array_equal(a, b)
        msgs = rng.integers(0, 2, (8, 64)).astype(np.int32)
        coded = PC.crc_attach(msgs, ps, device="cpu").numpy()
        np.testing.assert_array_equal(coded, np.asarray(JC.crc_attach(msgs,
                                                                      js)))
        np.testing.assert_array_equal(coded[0, 64:],
                                      PC.crc_remainder(msgs[0], ps))
        bad = coded.copy()
        bad[np.arange(8), rng.integers(0, bad.shape[1], 8)] ^= 1
        for words in (coded, bad):
            np.testing.assert_array_equal(
                PC.crc_check(words, ps, device="cpu").numpy(),
                np.asarray(JC.crc_check(words, js)))
        assert PC.crc_check(coded, ps, device="cpu").all()
        assert not PC.crc_check(bad, ps, device="cpu").any()
    np.testing.assert_array_equal(
        PC.crc_remainder(CHECK_BITS, name), JC.crc_remainder(CHECK_BITS, name))
    np.testing.assert_array_equal(PC.crc_check_table(name, 40),
                                  JC.crc_check_table(name, 40))
    attach = PC.make_crc_attach(name, 40, device="cpu")
    check = PC.make_crc_check(name, 40 + PC.CrcSpec.named(name).length,
                              device="cpu")
    assert check(attach(msgs[:, :40])).all()


def test_crc24c_follows_3gpp_not_the_jax_package():
    # CRC-24/NR-C, 3GPP TS 38.212 section 5.1: catalog check 0xF48279
    assert _as_int(PC.crc_remainder(CHECK_BITS, "crc24c")) == 0xF48279
    # the JAX package's polynomial (0x8F6E37) gives another check
    assert _as_int(JC.crc_remainder(CHECK_BITS, "crc24c")) == 0xBE7F82
    # the port's tables hold for its own polynomial
    affine = PC.CrcSpec(PC.CRC_POLYNOMIALS["crc24c"], 0x2A, 0x3)
    T, c0 = PC.crc_tables(affine, 45)
    rng = np.random.default_rng(9)
    for _ in range(5):
        m = rng.integers(0, 2, 45)
        np.testing.assert_array_equal((m @ T + c0) % 2,
                                      PC.crc_remainder(m, affine))
    # external catalog checks of the named specs (tests/test_crc_scramble.py)
    for spec, expect in ((PC.CrcSpec.named("crc16"), 0x31C3),
                         (PC.CrcSpec(PC.CRC_POLYNOMIALS["crc16"],
                                     init=0xFFFF), 0x29B1),
                         (PC.CrcSpec.named("crc24a"), 0xCDE703),
                         (PC.CrcSpec.named("crc24b"), 0x23EF52)):
        assert _as_int(PC.crc_remainder(CHECK_BITS, spec)) == expect
    with pytest.raises(ValueError):
        PC.crc_encode_table(affine, 40)


def test_crc32_bytes_matches_binascii():
    for data in (b"", b"123456789", b"hello world", bytes(range(256)),
                 b"\x00" * 40, b"\xff" * 33):
        assert PC.crc32_bytes(data) == binascii.crc32(data)


# ------------------------------------------------------------------------ TPC

def test_tpc_encode_and_decode_identical():
    jc, pc = JB.bch_construct(5, 2), PB.bch_construct(5, 2)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 2, (3, 21, 21))
    cw = np.asarray(JT.tpc_encode(jc, jc, jnp.asarray(data)))
    got = PT.tpc_encode(pc, pc, data, device="cpu")
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), cw)
    llr = ((1.0 - 2.0 * cw) * 4.0 + rng.normal(0, 2.2, cw.shape)).astype(
        np.float32)
    want = _np(JT.tpc_decode(jc, jc, llr))
    _same(PT.tpc_decode(pc, pc, llr, device="cpu"), want)
    assert (llr < 0).astype(int).__ne__(cw).sum() > 0  # the channel erred
    np.testing.assert_array_equal(want[1], cw)
    with pytest.raises(ValueError):
        PT.tpc_encode(pc, pc, data[:, :20], device="cpu")


# -------------------------------------------------------------- converters

def _tamper(genpoly):
    """The generator with its next-to-last coefficient changed."""
    g = list(genpoly)
    g[-2] ^= 1
    return tuple(g)


def test_bch_code_from_fields_round_trips_and_refuses_tampering():
    jb = JB.bch_construct(6, 3, shorten=13)
    fields = dataclasses.asdict(jb)
    assert convert.bch_code_from_fields(fields) == PB.bch_construct(
        6, 3, shorten=13)
    assert convert.bch_code_from_fields(jb) == PB.bch_construct(6, 3, 13)
    with pytest.raises(ValueError):
        convert.bch_code_from_fields(dict(fields,
                                          genpoly=_tamper(jb.genpoly)))
    with pytest.raises(ValueError):
        convert.bch_code_from_fields(dict(fields, k=jb.k - 1))
    with pytest.raises(KeyError):
        convert.bch_code_from_fields({key: v for key, v in fields.items()
                                      if key != "k"})


def test_rs_code_from_fields_round_trips_and_refuses_tampering():
    jr = JR.rs_construct(8, 8, shorten=51, fcr=0)
    fields = dataclasses.asdict(jr)
    assert convert.rs_code_from_fields(jr) == PR.rs_construct(8, 8, 51, 0)
    with pytest.raises(ValueError):
        convert.rs_code_from_fields(dict(fields,
                                         genpoly=_tamper(jr.genpoly)))
    with pytest.raises(ValueError):  # the same code at the other fcr
        convert.rs_code_from_fields(dict(fields, fcr=1))


def test_crc_spec_from_fields_round_trips_and_refuses_tampering():
    for name in ("crc16", "crc24a", "crc32"):
        js = JC.CrcSpec(JC.CRC_POLYNOMIALS[name], init=5, xorout=3)
        ps = convert.crc_spec_from_fields(dataclasses.asdict(js), name)
        assert ps == PC.CrcSpec(PC.CRC_POLYNOMIALS[name], 5, 3)
        poly = list(js.poly)
        poly[3] ^= 1
        with pytest.raises(ValueError):
            convert.crc_spec_from_fields(dict(dataclasses.asdict(js),
                                              poly=tuple(poly)), name)
        poly[-1] = 0
        with pytest.raises(ValueError):
            convert.crc_spec_from_fields(dict(dataclasses.asdict(js),
                                              poly=tuple(poly)))
    with pytest.raises(ValueError):
        convert.crc_spec_from_fields({"poly": (1, 0, 1), "init": 4,
                                      "xorout": 0})
    # the JAX package's crc24c is not the port's
    with pytest.raises(ValueError):
        convert.crc_spec_from_fields(
            dataclasses.asdict(JC.CrcSpec.named("crc24c")), "crc24c")
