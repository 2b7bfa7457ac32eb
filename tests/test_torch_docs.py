"""The port's Sphinx pages (``docs/torch/``) reference real modules.

``tests/test_docs.py``'s checks on ``docs/torch/``: every ``automodule``
target imports, in a fresh interpreter that must not import ``jax`` on
the way (the port imports neither JAX nor the JAX package); every
toctree entry of ``docs/torch/index.rst`` has a source file; and
``conf.py`` compiles.  Sphinx is not installed here, so the pages are
not built.
"""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs", "torch")


def _targets():
    pat = re.compile(r"^\.\.\s+automodule::\s+(\S+)", re.M)
    targets = set()
    for f in os.listdir(DOCS):
        if f.endswith(".rst"):
            with open(os.path.join(DOCS, f)) as fh:
                targets.update(pat.findall(fh.read()))
    return sorted(targets)


def test_automodule_targets_import_without_jax():
    targets = _targets()
    assert targets, "no automodule directives found"
    assert all(t.split(".")[0] == "commpy_tpu_torch" for t in targets)
    code = ("import importlib, sys\n"
            f"for m in {targets!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'commpy_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]


def test_every_port_subpackage_has_a_page():
    targets = set(_targets())
    for sub in ("ops", "kernels", "models", "parallel", "utils",
                "channelcoding"):
        pkg = os.path.join(ROOT, "commpy_tpu_torch", sub)
        mods = {f"commpy_tpu_torch.{sub}.{f[:-3]}" for f in os.listdir(pkg)
                if f.endswith(".py") and f != "__init__.py"}
        assert f"commpy_tpu_torch.{sub}" in targets
        assert mods <= targets, sorted(mods - targets)


def test_toctree_entries_exist():
    with open(os.path.join(DOCS, "index.rst")) as fh:
        text = fh.read()
    entries = re.findall(r"^\s{4}([a-z_0-9]+)\s*$", text, re.M)
    assert entries, "no toctree entries found"
    for e in entries:
        assert os.path.exists(os.path.join(DOCS, e + ".rst")), (
            f"toctree entry {e} has no source file")
    pages = {f[:-4] for f in os.listdir(DOCS) if f.endswith(".rst")}
    assert pages - {"index"} == set(entries)


def test_conf_compiles():
    with open(os.path.join(DOCS, "conf.py")) as fh:
        compile(fh.read(), "conf.py", "exec")
