"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: `repro_torch` is not `repro`), and nothing
reads the JAX package's CPU benchmarks."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "chipbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                  p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not {n.split(".")[0] for n in names} & FORBIDDEN, names
    jax_benchmarks = "bench" + "marks/"      # the JAX package's CPU runs
    assert jax_benchmarks not in path.read_text()


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in path.read_text(), path


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import types
    sys.path.insert(0, str(BENCH))
    from run import forbidden_modules
    for name in ("repro_torch", "repro_torch.models", "jaxtyping",
                 "reprox"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert forbidden_modules() == ["jax", "repro"]


def test_a_run_loads_neither(tmp_path):
    """A whole small run in a fresh process, then the loaded modules."""
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]\n"
        "from harness.small import small_cell\n"
        "from harness.cell_run import run_cell\n"
        "from run import forbidden_modules\n"
        "for name in ('dsmoe-prefill-2k', 'rwkv6-train-4k'):\n"
        "    run_cell(small_cell(name), 1, 0.2, True, torch.device('cpu'),\n"
        "             time.perf_counter())\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
