"""The port's docs gate (`python -m repro_torch.tools.check_docs`): every
public module of `repro_torch.{api,analysis,core,obs,serve}` and the pinned
extras (`hw.topology`, `hw.catalog`, `interop`) runs its docstring examples
with 0 failures, one case a module, so a module whose examples break
fails on its own; the gate's own exit code."""
import doctest
import importlib

import pytest

from repro_torch.tools import check_docs

MODULES = check_docs.doctest_modules()


def test_discovery_covers_the_port_surface():
    assert set(check_docs.EXTRA_MODULES) <= set(MODULES)
    for pkg in check_docs.DISCOVER_PACKAGES:
        assert pkg in MODULES
    for name in ("repro_torch.analysis.hlo", "repro_torch.analysis.probe",
                 "repro_torch.analysis.roofline",
                 "repro_torch.analysis.staticcheck.linter",
                 "repro_torch.analysis.staticcheck.tiers",
                 "repro_torch.api.session", "repro_torch.obs.tracing"):
        assert name in MODULES
    assert not any(part.startswith("_") for m in MODULES
                   for part in m.split("."))


@pytest.mark.parametrize("name", MODULES)
def test_module_doctests(name):
    res = doctest.testmod(importlib.import_module(name), verbose=False)
    assert res.failed == 0, f"{name}: {res.failed}/{res.attempted} failed"


def test_gate_exits_zero(capsys):
    assert check_docs.main() == 0
    out = capsys.readouterr().out
    assert f"over {len(MODULES)} modules, 0 failed" in out
