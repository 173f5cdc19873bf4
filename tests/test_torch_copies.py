"""Copy-drift guard: the modules of the DSE runtime, the data stream, the
pipeline planner and the fault-tolerance re-plans that the port keeps as
plain copies of the JAX package's equal the reference's source once every
`repro.` is rewritten to `repro_torch.` (imports, lazy imports and
docstring examples alike).  A change to either side that is not made to
the other fails here.  `serve/__init__.py` differs only in its docstring
(the port's token engine is torch, not jax), so there its code is held;
`api/session.py` differs only by the port's `device` keyword, so there the
code is held with that keyword taken out.  The sweep CLIs `run_shard`,
`merge_stores` and `sweep_top` (`repro_torch/tools/`) are held by their
code against the reference's `tools/`, the path set-up and the module
docstring taken out."""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

COPIES = ["api/archspec.py", "api/designspace.py", "api/resilience.py",
          "api/policies.py", "api/distributed.py", "api/__init__.py",
          "obs/events.py", "obs/tracing.py", "obs/realtime.py",
          "obs/export.py", "obs/report.py", "obs/__init__.py",
          "serve/arrivals.py", "serve/workloads.py", "serve/simulator.py",
          "train/data.py", "train/fault_tolerance.py", "core/planner.py"]


def ported(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference(rel):
    want = ported((REF / rel).read_text())
    got = (PORT / rel).read_text()
    assert got == want, f"src/repro_torch/{rel} drifted from src/repro/{rel}"


def _code(text: str) -> str:
    tree = ast.parse(text)
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


def test_serve_init_code_equals_reference():
    rel = "serve/__init__.py"
    assert _code((PORT / rel).read_text()) == \
        _code(ported((REF / rel).read_text()))


class _StripDevice(ast.NodeTransformer):
    """The port's one addition to `api/session.py`, taken out: the `device`
    parameter (last, default None) of `ExplorationSession.__init__` and of
    `explore`, the `self.device = device` it stores, the `device=` keyword
    it passes to `get_batched_fitness`, and the docstrings that mention it
    (the module's and `explore`'s)."""

    def visit_Module(self, node):
        self.generic_visit(node)
        node.body = _drop_docstring(node.body)
        return node

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        if node.name not in ("__init__", "explore"):
            return node
        args = node.args
        names = [a.arg for a in args.args]
        if names and names[-1] == "device":
            assert isinstance(args.defaults[-1], ast.Constant) and \
                args.defaults[-1].value is None
            args.args.pop()
            args.defaults.pop()
        node.body = [s for s in node.body if not _stores_device(s)]
        if node.name == "explore":
            node.body = _drop_docstring(node.body)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        if getattr(node.func, "id", None) == "get_batched_fitness":
            node.keywords = [k for k in node.keywords if k.arg != "device"]
        return node


def _drop_docstring(body):
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant) and \
            isinstance(body[0].value.value, str):
        return body[1:]
    return body


def _stores_device(stmt) -> bool:
    return (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
            and ast.unparse(stmt.targets[0]) == "self.device"
            and ast.unparse(stmt.value) == "device")


def _session_code(text: str) -> str:
    return ast.dump(_StripDevice().visit(ast.parse(text)))


def test_session_equals_reference_but_device():
    """`api/session.py` is the reference's module plus the `device`
    keyword: with that taken out, the two parse to the same tree."""
    rel = "api/session.py"
    port = (PORT / rel).read_text()
    assert "device" in port
    assert _session_code(port) == _session_code(ported((REF / rel).read_text()))


def _strip_path_hack(text: str) -> str:
    """The module's code without its docstring and without the statement
    that puts `src` on `sys.path` (the reference's CLIs run as scripts;
    the port's run as `python -m repro_torch.tools.<name>`)."""
    tree = ast.parse(text)
    body = [s for s in tree.body if not (
        isinstance(s, ast.Expr) and isinstance(s.value, ast.Call)
        and ast.unparse(s.value.func) == "sys.path.insert")]
    return _code(ast.unparse(ast.Module(body=body, type_ignores=[])))


@pytest.mark.parametrize("name", ["run_shard", "merge_stores", "sweep_top"])
def test_tool_code_equals_reference(name):
    """The port's sweep CLIs are the reference's `tools/<name>.py` with
    `repro.` rewritten, the path hack taken out and the module docstring
    naming the `-m` invocation (`trace_export` adds `--device`, and is
    held by its outputs in `test_torch_tools.py`)."""
    want = _strip_path_hack(ported((ROOT / "tools" / f"{name}.py")
                                   .read_text()))
    got = _strip_path_hack((PORT / "tools" / f"{name}.py").read_text())
    assert got == want
