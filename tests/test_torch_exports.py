"""What ``commpy_tpu_torch.ops``, ``.models``, ``.utils`` and ``.parallel``
export, held against ``commpy_tpu``.

Every name the JAX package's ``ops.__all__`` lists is exported by the
port (all 29 ``ops`` modules are ported); the port may list more of its
own submodules.  The port's ``parallel.__all__`` is the JAX package's.
The port's ``models.__all__`` holds all 15 link factories of the JAX
package's models and the device IDD loop, and nothing the JAX package's
models do not define.  The port's ``utils`` exports the profiling
helpers of ``commpy_tpu.utils.profiling``.  Importing the port's
``ops``, or the port with its CommPy-compatible modules and its
``parallel`` package, loads no ``jax`` and no ``commpy_tpu``.
"""
import importlib
import importlib.util
import subprocess
import sys
import types

import pytest

import commpy_tpu.models as jmodels
import commpy_tpu.models.device_links as jlinks
import commpy_tpu.ops as jops
import commpy_tpu.parallel as jparallel
import commpy_tpu.utils.profiling as jprofiling

import commpy_tpu_torch.models as models
import commpy_tpu_torch.ops as ops
import commpy_tpu_torch.parallel as parallel
import commpy_tpu_torch.utils as utils

# modules of commpy_tpu.ops the port has not ported yet (ROADMAP.md,
# queue 1): none
NOT_PORTED = set()
NEW_FACTORIES = {"make_rrc_conv_awgn_link", "make_isi_conv_link",
                 "make_bch_awgn_link", "make_rs_awgn_link",
                 "make_dvbs2_concat_link", "make_polar_awgn_link",
                 "make_idd_kbest_ldpc_mimo_link"}


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
    # polar: the JAX module's names, and the unrolled SCL maker it leaves
    # out of its __all__
    assert set(ops.polar.__all__) == set(jops.polar.__all__) | {
        "make_polar_scl_decoder_unrolled"}


@pytest.mark.parametrize("mods", [
    "commpy_tpu_torch.ops",
    "commpy_tpu_torch, commpy_tpu_torch.links, commpy_tpu_torch.wifi80211, "
    "commpy_tpu_torch.channelcoding, commpy_tpu_torch.utilities, "
    "commpy_tpu_torch.models, commpy_tpu_torch.utils.profiling",
    "commpy_tpu_torch.parallel, commpy_tpu_torch.parallel.dryrun, "
    "commpy_tpu_torch.ops.stream"])
def test_ops_import_loads_no_jax(mods):
    code = (f"import sys, {mods}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'commpy_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


def test_parallel_exports_the_jax_packages_names():
    assert parallel.__all__ == jparallel.__all__
    for name in parallel.__all__:
        assert hasattr(parallel, name), name
    assert set(ops.stream.__all__) == set(jops.stream.__all__)
    assert set(ops.fir.__all__) == set(jops.fir.__all__)
    for mod in ("ldpc", "qcldpc"):
        jmod = importlib.import_module(f"commpy_tpu.ops.{mod}")
        assert {n for n in jmod.__all__ if "sharded" in n} <= \
            set(getattr(ops, mod).__all__)


def test_models_export_the_ported_link_factories():
    # the JAX package's models export: its models.__all__ and its
    # device_links.__all__ (which alone lists make_bestfirst_ldpc_mimo_link)
    # and the factories device_links defines (neither __all__ lists
    # make_idd_kbest_ldpc_mimo_link)
    jax_factories = {name for name in dir(jlinks)
                     if name.startswith("make_") and name.endswith("_link")}
    jax_names = set(jmodels.__all__) | set(jlinks.__all__) | jax_factories
    assert NEW_FACTORIES <= set(models.__all__)
    assert set(models.__all__) <= jax_names
    assert jax_factories <= set(models.__all__)
    assert len(jax_factories) == 15
    assert len({n for n in models.__all__ if n.startswith("make_")}) == 15
    assert "idd_decoder_device" in models.__all__
    for name in models.__all__:
        assert hasattr(models, name), name


def test_utils_exports_profiling():
    assert "profiling" in utils.__all__
    # the JAX module's names, and the port's gated spans
    assert set(utils.profiling.__all__) == set(jprofiling.__all__) | {
        "span", "recording"}
    for name in utils.profiling.__all__:
        assert hasattr(utils.profiling, name), name


def test_profiling_helpers_on_cpu(tmp_path):
    import torch

    x = torch.randn(64, 64)
    with utils.profiling.trace(str(tmp_path / "t")) as prof:
        (x @ x).sum()
    files = list((tmp_path / "t").glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert any("matmul" in e.key or "mm" in e.key
               for e in prof.key_averages())
    meter = utils.profiling.Throughput()
    for _ in range(2):
        with meter.measure(1000):
            (x @ x).sum()
    assert meter.items == 2000 and meter.per_second > 0
    assert utils.profiling.benchmark(lambda a: a @ a, x, iters=3) > 0
