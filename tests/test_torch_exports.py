"""What ``commpy_tpu_torch.ops`` exports, held against ``commpy_tpu.ops``.

Every name the JAX package's ``ops.__all__`` lists is exported by the
port, except the modules the port has not reached yet (ROADMAP.md,
queue 1, items 3-7); the port may list more of its own submodules.
Importing the port's ``ops`` loads no ``jax`` and no ``commpy_tpu``.
"""
import importlib.util
import subprocess
import sys
import types

import commpy_tpu.ops as jops

import commpy_tpu_torch.ops as ops

# modules of commpy_tpu.ops the port has not ported yet, by ROADMAP.md
# queue 1 item: 3 single-carrier DSP; 4 algebraic codes; 5 polar;
# 6 multi-GPU streams
NOT_PORTED = {
    "filters", "sequences", "fir", "equalize",
    "galois", "bch", "rs", "tpc", "algebraic", "crc",
    "polar",
    "stream",
}


def test_ops_exports_what_the_port_has_ported():
    assert NOT_PORTED <= set(jops.__all__)
    assert set(jops.__all__) - NOT_PORTED <= set(ops.__all__)
    for name in ops.__all__:
        assert hasattr(ops, name), name
        # an extra name is a submodule the JAX package has too
        if name not in jops.__all__:
            assert isinstance(getattr(ops, name), types.ModuleType)
            assert importlib.util.find_spec(f"commpy_tpu.ops.{name}")
    assert ops.Trellis is ops.trellis.Trellis
    assert ops.viterbi_decode is ops.viterbi.viterbi_decode
    assert ops.viterbi_decode_device is ops.viterbi.viterbi_decode_device


def test_ops_import_loads_no_jax():
    code = ("import sys, commpy_tpu_torch.ops\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'commpy_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
