"""CLI: ``python -m repro_torch.analysis [--check] [--audit] ...``.

Modes (combinable; with no mode flags, ``--check`` is implied):

* ``--check``          run the repo-invariant linter; exit nonzero on any
                       finding not in the baseline file.
* ``--audit``          run the CNF encoding auditor over the suite cells
                       (cold + incremental projections); exit nonzero on
                       any unsuppressed finding.  ``--quick`` audits a
                       4-kernel subset; default is all 11 kernels x 3
                       fabrics (33 cells, ~4 s).
* ``--write-baseline`` rewrite the lint baseline from current findings.

Options: ``--root DIR`` lints a different tree (used by the fixture
tests), ``--baseline PATH`` overrides the suppression file,
``--rules a,b`` restricts the rule set, ``--report PATH`` writes the
audit report JSON (the CI artifact), ``--emitters``/``--amo`` select
encoder modes for the audit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .lint import LintConfig, load_baseline, run_lint, write_baseline

_QUICK_NAMES = ("sha", "nw", "srand", "hotspot")


def _do_check(args: argparse.Namespace) -> int:
    cfg = LintConfig(root=Path(args.root),
                     baseline_path=(Path(args.baseline)
                                    if args.baseline else None),
                     rules=(args.rules.split(",") if args.rules else None))
    findings = run_lint(cfg)
    if args.write_baseline:
        path = cfg.baseline_path or (cfg.scan_dir / "analysis"
                                     / "lint_baseline.txt")
        write_baseline(path, findings)
        print(f"lint: wrote {len(findings)} fingerprint(s) to {path}")
        return 0
    baseline = load_baseline(cfg.baseline_path)
    fresh = [f for f in findings if f.fingerprint not in baseline]
    stale = baseline - {f.fingerprint for f in findings}
    for f in fresh:
        print(f.render())
    if stale:
        print(f"lint: note: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} (fixed or moved):")
        for fp in sorted(stale):
            print(f"    {fp}")
    n_base = len(findings) - len(fresh)
    print(f"lint: {len(findings)} finding(s), {n_base} baselined, "
          f"{len(fresh)} new -> {'FAIL' if fresh else 'OK'}")
    return 1 if fresh else 0


def _do_audit(args: argparse.Namespace) -> int:
    # late import: the auditor pulls in the encoder stack (numpy etc.),
    # which a lint-only invocation should not need.
    from .cnf_audit import audit_suite, reports_to_json

    names = list(_QUICK_NAMES) if args.quick else None
    progress = (lambda r: print(r.summary())) if args.verbose else None
    t0 = time.perf_counter()
    reports = audit_suite(names=names, amo=args.amo,
                          emitters=args.emitters, progress=progress)
    dt = time.perf_counter() - t0
    payload = reports_to_json(reports)
    if args.report:
        Path(args.report).write_text(json.dumps(payload, indent=1,
                                                sort_keys=True))
        print(f"audit: report written to {args.report}")
    bad = [r for r in reports if not r.ok()]
    for r in bad:
        print(r.summary())
    print(f"audit: {len(reports)} report(s) over {len(payload['cells'])} "
          f"cell(s), {payload['n_suppressed']} suppressed, "
          f"{payload['n_unsuppressed']} unsuppressed "
          f"({dt:.1f}s) -> {'FAIL' if bad else 'OK'}")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="run the repo-invariant linter gate")
    ap.add_argument("--audit", action="store_true",
                    help="run the CNF encoding auditor over the suite")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the lint baseline from current findings")
    ap.add_argument("--root", default=".",
                    help="tree to lint (default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help="lint suppression file override")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset")
    ap.add_argument("--quick", action="store_true",
                    help="audit a 4-kernel subset instead of all 11")
    ap.add_argument("--report", default=None,
                    help="write the audit report JSON here")
    ap.add_argument("--emitters", default="vector",
                    choices=("vector", "legacy"))
    ap.add_argument("--amo", default="pairwise",
                    choices=("pairwise", "sequential"))
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if not (args.check or args.audit or args.write_baseline):
        args.check = True
    rc = 0
    if args.check or args.write_baseline:
        rc |= _do_check(args)
    if args.audit:
        rc |= _do_audit(args)
    return rc


if __name__ == "__main__":
    sys.exit(main())
