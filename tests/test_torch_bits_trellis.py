"""commpy_tpu_torch bits, trellis tables and convert, held against commpy_tpu.

The same NumPy inputs go to both packages; every table must be identical.
"""
import numpy as np
import pytest
import torch

from commpy_tpu.ops.trellis import Trellis as JTrellis
from commpy_tpu.utils import bits as jbits
from commpy_tpu_torch.convert import (TABLE_KEYS, trellis_from_tables,
                                      trellis_tables)
from commpy_tpu_torch.ops.trellis import Trellis
from commpy_tpu_torch.utils import bits as pbits

torch.set_num_threads(1)

# (memory, g_matrix, feedback, code_type, polynomial_format)
CODES = {
    "5_7": (np.array([2]), np.array([[5, 7]]), None, "default", "MSB"),
    "k7_133_171": (np.array([6]), np.array([[0o133, 0o171]]), None,
                   "default", "MSB"),
    "mem8_561_753": (np.array([8]), np.array([[0o561, 0o753]]), None,
                     "default", "MSB"),
    "rsc_legacy_int": (np.array([2]), np.array([[1, 7]]), 5, "rsc", "MSB"),
    "rsc_matrix_k1": (np.array([2]), np.array([[1, 5]]), np.array([[7]]),
                      "rsc", "MSB"),
    "k2_msb": (np.array([2, 1]), np.array([[5, 7, 0], [0, 2, 3]]), None,
               "default", "MSB"),
    "k2_lsb": (np.array([2, 1]), np.array([[5, 7, 0], [0, 2, 6]]), None,
               "default", "LSB"),
    "k2_rsc_matrix": (np.array([1, 1]), np.array([[1, 0, 0], [0, 1, 3]]),
                      np.array([[2, 2], [3, 1]]), "rsc", "MSB"),
}

# tests/test_convcode.py:34-73 (reference commpy test goldens)
GOLDEN = {
    "5_7": ([[0, 2], [0, 2], [1, 3], [1, 3]], [[0, 3], [3, 0], [1, 2],
                                                [2, 1]]),
    "rsc_legacy_int": ([[0, 2], [2, 0], [1, 3], [3, 1]],
                       [[0, 3], [0, 3], [1, 2], [1, 2]]),
    "k2_msb": ([[0, 1, 4, 5]] * 4 + [[2, 3, 6, 7]] * 4,
               [[0, 1, 6, 7], [3, 2, 5, 4], [6, 7, 0, 1], [5, 4, 3, 2],
                [2, 3, 4, 5], [1, 0, 7, 6], [4, 5, 2, 3], [7, 6, 1, 0]]),
    "k2_lsb": ([[0, 1, 4, 5]] * 4 + [[2, 3, 6, 7]] * 4,
               [[0, 1, 6, 7], [3, 2, 5, 4], [6, 7, 0, 1], [5, 4, 3, 2],
                [2, 3, 4, 5], [1, 0, 7, 6], [4, 5, 2, 3], [7, 6, 1, 0]]),
    "k2_rsc_matrix": ([[0, 1, 1, 0], [2, 3, 3, 2], [3, 2, 2, 3],
                       [1, 0, 0, 1]],
                      [[0, 3, 4, 7], [1, 2, 5, 6], [0, 3, 4, 7],
                       [1, 2, 5, 6]]),
}

ALL_TABLES = TABLE_KEYS + ("output_bits",)


@pytest.mark.parametrize("width", [1, 3, 7, 16])
def test_bits_match_jax(width):
    rng = np.random.RandomState(width)
    x = rng.randint(0, 2 ** width, (5, 9)).astype(np.int32)
    ju = np.asarray(jbits.unpack_bits(x, width))
    pu = pbits.unpack_bits(torch.as_tensor(x), width).numpy()
    np.testing.assert_array_equal(ju, pu)
    assert pu.dtype == np.int8
    np.testing.assert_array_equal(np.asarray(jbits.pack_bits(ju)),
                                  pbits.pack_bits(torch.as_tensor(pu)).numpy())
    np.testing.assert_array_equal(jbits.np_unpack_bits(x, width),
                                  pbits.np_unpack_bits(x, width))
    np.testing.assert_array_equal(jbits.np_pack_bits(ju),
                                  pbits.np_pack_bits(ju))


@pytest.mark.parametrize("name", sorted(CODES))
def test_trellis_tables_match_jax(name):
    j, p = JTrellis(*CODES[name]), Trellis(*CODES[name])
    for key in ALL_TABLES:
        np.testing.assert_array_equal(getattr(j, key), getattr(p, key),
                                      err_msg=key)
    for key in ("k", "n", "total_memory", "number_states", "number_inputs",
                "is_feedforward", "code_type"):
        assert getattr(j, key) == getattr(p, key), key
    if j.g_taps is None:
        assert p.g_taps is None
    else:
        np.testing.assert_array_equal(j.g_taps, p.g_taps)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_trellis_goldens(name):
    t = Trellis(*CODES[name])
    nst, out = GOLDEN[name]
    np.testing.assert_array_equal(t.next_state_table, nst)
    np.testing.assert_array_equal(t.output_table, out)


@pytest.mark.parametrize("name", sorted(CODES))
def test_trellis_from_tables_roundtrip(name):
    jt = JTrellis(*CODES[name])
    built = Trellis(*CODES[name])
    carried = trellis_from_tables(trellis_tables(jt))
    for key in ALL_TABLES:
        np.testing.assert_array_equal(getattr(carried, key),
                                      getattr(built, key), err_msg=key)
    for key in ("k", "n", "total_memory", "number_states", "number_inputs"):
        assert getattr(carried, key) == getattr(built, key), key
    assert trellis_tables(carried).keys() == trellis_tables(built).keys()


def test_trellis_from_tables_rejects_inconsistent_tables():
    d = trellis_tables(JTrellis(*CODES["5_7"]))
    bad = dict(d, pred_input_table=1 - d["pred_input_table"])
    with pytest.raises(ValueError, match="pred_input_table"):
        trellis_from_tables(bad)
    with pytest.raises(KeyError):
        trellis_from_tables({k: v for k, v in d.items() if k != "n"})


def test_trellis_rejects_unknown_polynomial_format():
    with pytest.raises(ValueError, match="polynomial_format"):
        Trellis(np.array([2]), np.array([[5, 7]]), polynomial_format="x")
