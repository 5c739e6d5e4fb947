"""The port's static-analysis gate (``repro_torch.analysis``): each lint
rule on its fixture trees under ``tests/fixtures/lint_torch/``, the port's
own tree clean against its (empty) baseline, the CLI's exit codes, and the
CNF auditor over the port's encoder giving the JAX package's reports."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import audit_suite as ref_audit_suite
from repro_torch.analysis import LintConfig, load_baseline, run_lint
from repro_torch.analysis.__main__ import _QUICK_NAMES
from repro_torch.analysis.cnf_audit import audit_suite
from repro_torch.analysis.lint import write_baseline

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "lint_torch"
BAD = {"fork_bad": ("fork-safety", 2), "opt_bad": ("opt-safety", 1),
       "hash_bad": ("hash-determinism", 3),
       "cuda_bad": ("cuda-wrapper", 3)}
GOOD = ("fork_good", "opt_good", "hash_good", "cuda_good")


def lint_tree(name):
    return run_lint(LintConfig(root=FIXTURES / name))


# ------------------------------------------------------------ rule engine

@pytest.mark.parametrize("tree", sorted(BAD))
def test_bad_fixture_trips_its_rule(tree):
    rule, n = BAD[tree]
    findings = lint_tree(tree)
    assert [f.rule for f in findings] == [rule] * n
    fps = [f.fingerprint for f in findings]
    assert len(fps) == len(set(fps))


@pytest.mark.parametrize("tree", GOOD)
def test_good_fixture_is_clean(tree):
    assert lint_tree(tree) == []


def test_fork_safety_reports_the_chain():
    """torch two hops from the fixture's ``cdcl`` module, and triton in the
    package that holds it (Python imports the package first)."""
    by_path = {f.path: f for f in lint_tree("fork_bad")}
    heavy = by_path["pkg/heavy.py"]
    assert "`torch`" in heavy.message
    assert "pkg.sat.cdcl -> pkg.middle -> pkg.heavy" in heavy.message
    pkg = by_path["pkg/sat/__init__.py"]
    assert "`triton`" in pkg.message and "pkg.sat.cdcl -> pkg.sat" in \
        pkg.message


def test_cuda_wrapper_names_each_check():
    tokens = sorted(f.token for f in lint_tree("cuda_bad"))
    assert tokens == ["f64:float64", "no-ref:kernels/foo",
                      "swallow:RuntimeError"]


def test_fork_safety_catches_torch_in_the_real_cdcl_closure(tmp_path):
    """A copy of the port with a module-scope torch import in
    ``core/__init__.py`` (a package the CDCL worker's import runs)."""
    root = tmp_path / "tree"
    shutil.copytree(REPO / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    init = root / "src" / "repro_torch" / "core" / "__init__.py"
    init.write_text("import torch  # noqa: F401\n" + init.read_text())
    findings = run_lint(LintConfig(root=root, rules=["fork-safety"]))
    assert [(f.path, f.token) for f in findings] == \
        [("repro_torch/core/__init__.py", "repro_torch.core->torch")]
    assert "repro_torch.core.sat.cdcl" in findings[0].message


def test_baseline_suppresses_and_roundtrips(tmp_path):
    findings = lint_tree("opt_bad")
    path = tmp_path / "baseline.txt"
    write_baseline(path, findings)
    assert {f.fingerprint for f in findings} <= load_baseline(path)
    assert load_baseline(None) == set()
    assert load_baseline(tmp_path / "missing.txt") == set()


def test_port_lints_clean_against_its_baseline():
    cfg = LintConfig(root=REPO)
    assert cfg.baseline_path == (REPO / "src" / "repro_torch" / "analysis"
                                 / "lint_baseline.txt")
    assert load_baseline(cfg.baseline_path) == set()
    findings = run_lint(cfg)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_lint_reads_only_the_port():
    from repro_torch.analysis.lint import build_context
    ctx = build_context(LintConfig(root=REPO))
    assert ctx.files and all(rel.startswith("repro_torch/")
                             for rel in ctx.files)
    assert "repro_torch.core.sat.cdcl" in ctx.modules


# -------------------------------------------------------------------- CLI

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_exits_zero_on_repo():
    proc = _cli("--check")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new -> OK" in proc.stdout


@pytest.mark.parametrize("tree", sorted(BAD))
def test_cli_nonzero_on_each_bad_fixture(tree):
    proc = _cli("--check", "--root", str(FIXTURES / tree))
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "FAIL" in proc.stdout


@pytest.mark.parametrize("tree", GOOD)
def test_cli_zero_on_each_good_fixture(tree):
    proc = _cli("--check", "--root", str(FIXTURES / tree))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_baseline_override_suppresses(tmp_path):
    base = tmp_path / "b.txt"
    write_baseline(base, lint_tree("cuda_bad"))
    proc = _cli("--check", "--root", str(FIXTURES / "cuda_bad"),
                "--baseline", str(base))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_quick_audit_writes_its_report(tmp_path):
    import json
    report = tmp_path / "audit.json"
    proc = _cli("--audit", "--quick", "--rules", "opt-safety",
                "--report", str(report))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(report.read_text())
    assert payload["ok"] and payload["n_unsuppressed"] == 0
    assert len(payload["cells"]) == 3 * len(_QUICK_NAMES)


# ------------------------------------------------------ CNF audit parity

def _audit_pair(names, **kw):
    ours = audit_suite(names=names, **kw)
    ref = ref_audit_suite(names=names, **kw)
    assert [r.to_dict() for r in ours] == [r.to_dict() for r in ref]
    assert all(r.ok() for r in ours)
    for r in ours:
        if r.mode == "cold":
            assert set(r.family_counts) == {"c1", "c2", "c2w", "c3"}
            for fam, (actual, expected) in r.family_counts.items():
                assert actual == expected, (r.cell, fam)
    return ours


@pytest.mark.parametrize("amo,emitters", [("pairwise", "vector"),
                                          ("pairwise", "legacy"),
                                          ("sequential", "vector")])
def test_quick_audit_equals_the_reference(amo, emitters):
    """The ``--quick`` subset: per-cell family counts, findings and
    ``ok()`` equal the JAX package's audit of its own encoder."""
    reports = _audit_pair(list(_QUICK_NAMES), amo=amo, emitters=emitters)
    assert len(reports) == 2 * 3 * len(_QUICK_NAMES)


@pytest.mark.slow
def test_full_audit_equals_the_reference():
    reports = _audit_pair(None)
    assert len({r.cell for r in reports}) == 33
