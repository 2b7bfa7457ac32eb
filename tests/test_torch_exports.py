"""What ``commpy_tpu_torch.ops`` and ``.models`` export, held against
``commpy_tpu``.

Every name the JAX package's ``ops.__all__`` lists is exported by the
port, except the modules the port has not reached yet (ROADMAP.md,
queue 1); the port may list more of its own submodules.  The port's
``models.__all__`` holds every link factory of the JAX package's models
but the two of later slices, and nothing the JAX package's models do not
export.  Importing the port's ``ops`` loads no ``jax`` and no
``commpy_tpu``.
"""
import importlib.util
import subprocess
import sys
import types

import commpy_tpu.models as jmodels
import commpy_tpu.models.device_links as jlinks
import commpy_tpu.ops as jops

import commpy_tpu_torch.models as models
import commpy_tpu_torch.ops as ops

# modules of commpy_tpu.ops the port has not ported yet, by ROADMAP.md
# queue 1 item: polar; multi-GPU streams
NOT_PORTED = {
    "polar",
    "stream",
}
# link factories of later slices: polar; the CommPy-compatible IDD
FACTORIES_NOT_PORTED = {"make_polar_awgn_link",
                        "make_idd_kbest_ldpc_mimo_link"}
NEW_FACTORIES = {"make_rrc_conv_awgn_link", "make_isi_conv_link",
                 "make_bch_awgn_link", "make_rs_awgn_link",
                 "make_dvbs2_concat_link"}


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


def test_models_export_the_ported_link_factories():
    # the JAX package's models export: its models.__all__ and its
    # device_links.__all__ (which alone lists make_bestfirst_ldpc_mimo_link)
    jax_names = set(jmodels.__all__) | set(jlinks.__all__)
    jax_factories = {name for name in dir(jlinks)
                     if name.startswith("make_") and name.endswith("_link")}
    assert NEW_FACTORIES <= set(models.__all__)
    assert set(models.__all__) <= jax_names - FACTORIES_NOT_PORTED
    assert jax_factories - FACTORIES_NOT_PORTED <= set(models.__all__)
    assert len(jax_factories) == 15
    assert len({n for n in models.__all__ if n.startswith("make_")}) == 13
    for name in models.__all__:
        assert hasattr(models, name), name
