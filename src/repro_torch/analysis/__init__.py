"""Static analysis for the port: `python -m repro_torch.analysis`.

Two engines, one gate, over the port's own code (the JAX package has its
own, ``repro.analysis``):

* :mod:`repro_torch.analysis.cnf_audit` — a vectorised numpy auditor for
  the SAT encodings that the port's encoder (``repro_torch.core.encode``)
  emits: duplicate / subsumed / tautological clauses, dead or
  out-of-range variables, AMO-family completeness and overlap, and
  per-family clause counts cross-checked against closed-form formulas
  re-derived from the KMS windows (an independent model of the encoder,
  not a call back into it). It still holds if the port's encoder ever
  departs from the reference's.
* :mod:`repro_torch.analysis.lint` — an AST / import-graph rule engine
  for the port's load-bearing invariants: a torch-free CDCL fork closure,
  ``python -O`` assert safety, ``PYTHONHASHSEED``-independent canonical
  keys, and CUDA wrappers that keep their plain version and never fall
  back. Legacy violations would live in a checked-in baseline file
  (empty); anything new fails the gate.

CLI: ``python -m repro_torch.analysis --check`` (lint gate),
``--audit`` (33-cell suite encoding audit), ``--write-baseline``.
"""
from .cnf_audit import (AuditError, AuditReport, Finding, audit_encoding,
                        audit_projection, audit_suite)
from .lint import LintConfig, LintFinding, load_baseline, run_lint

__all__ = [
    "AuditError", "AuditReport", "Finding", "audit_encoding",
    "audit_projection", "audit_suite",
    "LintConfig", "LintFinding", "load_baseline", "run_lint",
]
