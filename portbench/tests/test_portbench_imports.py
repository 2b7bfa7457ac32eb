"""Nothing the benchmark runs imports JAX or the JAX package, or reads
the JAX package's own benchmark script or folder."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
BANNED = {"jax", "jaxlib", "flax", "commpy_tpu", "bench", "benchmarks"}
MODULES = sorted(p for p in PKG.rglob("*.py"))
# the JAX package's benchmark, spelled so that this file does not name it
JAX_BENCH_DIR = "benchmarks" + "/"
JAX_BENCH_SCRIPT = "bench" + ".py"


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_banned_import(path):
    tree = ast.parse(path.read_text())
    tops = {name.partition(".")[0] for name in _imported(tree)}
    assert not tops & BANNED, f"{path} imports {sorted(tops & BANNED)}"
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert JAX_BENCH_DIR not in node.value
            assert node.value != JAX_BENCH_SCRIPT


def test_call_strings_name_the_port_only():
    """Factory calls in the configurations name the port's modules."""
    import json
    for cfg in (PKG / "configs").glob("*.json"):
        text = json.loads(cfg.read_text())
        calls = [text["factory"]["call"]] + [
            v["call"] for v in text["factory"].get("kwargs", {}).values()
            if isinstance(v, dict) and "call" in v]
        for call in calls:
            assert call.partition(":")[0].partition(".")[0] == "commpy_tpu_torch"


def test_dry_import_loads_no_banned_module():
    """Every module of the benchmark and the cells' link factories,
    imported in a fresh process, leave no banned top-level name loaded."""
    code = (
        "import sys, importlib, json, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "pkg = pathlib.Path(sys.path[0]) / 'portbench'\n"
        "for p in sorted(pkg.rglob('*.py')):\n"
        "    if 'tests' in p.parts: continue\n"
        "    name = '.'.join(p.relative_to(pkg.parent).with_suffix('').parts)\n"
        "    if name.endswith('__init__'): name = name[:-9]\n"
        "    importlib.import_module(name)\n"
        "from portbench import harness\n"
        "for cfg in (pkg / 'configs').glob('*.json'):\n"
        "    harness.build_link(json.loads(cfg.read_text()), 'cpu')\n"
        f"print(sorted({{m.partition('.')[0] for m in sys.modules}} & {BANNED!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
