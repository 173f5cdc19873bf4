"""The port's determinism linter (`repro_torch.analysis.staticcheck`)
against the JAX package's (`tests/test_staticcheck.py:40-141` there): the
shared fixture corpus with exact rule IDs and line numbers, the pragma
machinery, the port's tier map, torch's process-global RNG, the
port-lints-clean gate and its CLI (`python -m repro_torch.tools.
check_static`: exit 0 clean, 5 under `--strict` with violations, JSON)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import staticcheck as ref_staticcheck

from repro_torch.analysis import staticcheck
from repro_torch.analysis.staticcheck import (DETERMINISTIC, REALTIME, RULES,
                                              lint_paths, lint_source,
                                              rule_applies, tier_of_module,
                                              tier_of_path)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FIXTURES = Path(__file__).parent / "staticcheck_fixtures"

# fixture -> (rule, line) of its unallowed findings, as the reference's
# tests pin them
FIXTURE_FINDINGS = {
    "bad_wall_clock.py": [("wall-clock", 8), ("wall-clock", 9),
                          ("wall-clock", 10), ("wall-clock", 11)],
    "bad_unseeded_rng.py": [("unseeded-rng", 10), ("unseeded-rng", 11),
                            ("unseeded-rng", 12), ("unseeded-rng", 13),
                            ("unseeded-rng", 14)],
    "bad_wallclock_arrivals.py": [("wall-clock", 13), ("unseeded-rng", 14),
                                  ("wall-clock", 19)],
    "bad_wallclock_span.py": [("wall-clock", 16), ("wall-clock", 17),
                              ("wall-clock", 18)],
    "bad_id_hash.py": [("id-hash", 6), ("id-hash", 10)],
    "bad_iter_order.py": [("iter-order", 9), ("iter-order", 11),
                          ("iter-order", 12)],
    "bad_submit_lambda.py": [("unpicklable-submit", 9),
                             ("unpicklable-submit", 12),
                             ("unpicklable-submit", 14)],
    "good_pragmas.py": [],
    "bad_pragma.py": [("bad-pragma", 6), ("wall-clock", 6),
                      ("bad-pragma", 10), ("wall-clock", 10)],
}


def _findings(name: str, lint=lint_paths):
    """(rule, line) pairs of unallowed findings in one fixture file."""
    vs = lint([str(FIXTURES / name)], tier=DETERMINISTIC)
    return [(v.rule, v.line) for v in vs if not v.allowed]


@pytest.mark.parametrize("name", sorted(FIXTURE_FINDINGS))
def test_fixture_findings(name):
    """Each fixture's findings are the reference's pins and the reference
    linter's own findings, rule for rule and line for line."""
    assert _findings(name) == FIXTURE_FINDINGS[name]
    assert _findings(name) == _findings(name, ref_staticcheck.lint_paths)


def test_good_pragmas_stay_visible_as_allowed():
    vs = lint_paths([str(FIXTURES / "good_pragmas.py")], tier=DETERMINISTIC)
    assert [(v.rule, v.line, v.allowed) for v in vs] == [
        ("wall-clock", 7, True), ("wall-clock", 13, True)]


def test_pragma_in_docstring_is_not_a_pragma():
    src = '"""uses # staticcheck: allow(wall-clock) in prose"""\n' \
          "import time\nt = time.time()\n"
    vs = lint_source(src, tier=DETERMINISTIC)
    assert [(v.rule, v.allowed) for v in vs] == [("wall-clock", False)]


def test_parse_error_is_reported():
    assert [v.rule for v in lint_source("def broken(:\n")] == ["parse-error"]


def test_torch_global_rng():
    """torch's process-global generator is the same rule on every tier:
    seeding it or drawing from it without `generator=` is flagged; a
    sampler given a seeded torch.Generator is not."""
    src = ("import torch\n"
           "from torch import randn as draw\n"
           "torch.manual_seed(0)\n"
           "torch.seed()\n"
           "a = torch.rand(3)\n"
           "b = draw(3)\n"
           "c = torch.randint(0, 5, (3,))\n"
           "d = torch.randperm(4)\n"
           "e = torch.normal(0.0, 1.0, (3,))\n"
           "f = torch.bernoulli(a)\n"
           "g = torch.multinomial(a, 1)\n"
           "gen = torch.Generator().manual_seed(0)\n"
           "h = torch.randn(3, generator=gen)\n"
           "i = torch.randperm(4, generator=gen)\n"
           "j = torch.random.manual_seed(1)\n")
    for tier in (DETERMINISTIC, REALTIME):
        vs = lint_source(src, tier=tier)
        assert [(v.rule, v.line) for v in vs] == [
            ("unseeded-rng", n) for n in (3, 4, 5, 6, 7, 8, 9, 10, 11, 15)]
    # the reference's linter, which knows no torch, passes all of it
    assert ref_staticcheck.lint_source(src, tier=DETERMINISTIC) == []


def test_tier_map():
    assert tier_of_module("repro_torch.core.scheduler") == DETERMINISTIC
    assert tier_of_module("repro_torch.api.session") == DETERMINISTIC
    assert tier_of_module("repro_torch.launch.serve") == REALTIME
    assert tier_of_module("repro_torch.launch.dryrun") == REALTIME
    assert tier_of_module("repro_torch.core.vectorized") == DETERMINISTIC
    assert tier_of_module("repro_torch.serve.engine") == DETERMINISTIC
    assert tier_of_module("repro_torch.obs.tracing") == DETERMINISTIC
    assert tier_of_module("repro_torch.obs.realtime") == REALTIME
    assert tier_of_path("src/repro_torch/hw/topology.py") == DETERMINISTIC
    assert tier_of_path("src/repro_torch/kernels/build.py") == DETERMINISTIC
    assert tier_of_path("benchmarks/run.py") == REALTIME
    assert tier_of_path("src/repro/hw/topology.py") == REALTIME
    # wall-clock is tier-scoped; RNG hygiene applies everywhere
    assert not rule_applies("wall-clock", REALTIME)
    assert rule_applies("unseeded-rng", REALTIME)
    src = "import time\nt = time.time()\nimport random\nr = random.random()\n"
    assert [v.rule for v in lint_source(src, tier=REALTIME)] \
        == ["unseeded-rng"]


def test_tiers_pin_the_references_modules():
    """Every pin of the reference's map, under `repro_torch.`."""
    want = tuple((p.replace("repro", "repro_torch", 1), t)
                 for p, t in ref_staticcheck.MODULE_TIERS)
    assert staticcheck.MODULE_TIERS == want


def test_port_lints_clean():
    """The merge gate: src/repro_torch has zero unallowed violations, every
    suppression names a known rule, and the allowed ones are the
    reference's nine plus the nvcc build's two timings."""
    vs = lint_paths([str(PORT)])
    assert [v.format() for v in vs if not v.allowed] == []
    assert all(v.rule in RULES for v in vs)
    allowed = [(os.path.relpath(v.path, PORT), v.rule) for v in vs]
    ref = ref_staticcheck.lint_paths([str(ROOT / "src" / "repro")])
    assert len(ref) == 9 and all(v.allowed for v in ref)
    assert sorted(allowed) == sorted(
        [(os.path.relpath(v.path, ROOT / "src" / "repro"), v.rule)
         for v in ref] + [("kernels/build.py", "wall-clock")] * 2)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.check_static", *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)


def test_cli_strict_clean_port_exits_zero():
    proc = _cli("--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "staticcheck: 0 violations, 11 pragma-allowed" in proc.stdout


def test_cli_strict_exits_5_on_violations():
    # RNG hygiene applies on every tier, so the fixture trips the CLI too
    proc = _cli("--strict", str(FIXTURES / "bad_unseeded_rng.py"))
    assert proc.returncode == 5
    assert "unseeded-rng" in proc.stdout
    # not strict: reported, exit 0
    assert _cli(str(FIXTURES / "bad_unseeded_rng.py")).returncode == 0


def test_cli_json_format():
    proc = _cli("--format", "json", str(FIXTURES / "bad_unseeded_rng.py"))
    report = json.loads(proc.stdout)
    assert report["summary"] == {"unallowed": 5, "allowed": 0,
                                 "strict": False}
    assert {v["rule"] for v in report["violations"]} == {"unseeded-rng"}
    assert all(v["line"] for v in report["violations"])
    assert {v["path"] for v in report["violations"]} == {
        "tests/staticcheck_fixtures/bad_unseeded_rng.py"}
