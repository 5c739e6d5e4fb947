"""Port-invariant linter: AST / import-graph rules over the port's tree.

The rules encode the port's load-bearing conventions — things that are
*correct today* only because every change so far has been careful:

* ``fork-safety`` — no module-scope ``torch``/``triton``/``jax``/
  ``optax`` import reachable from the CDCL worker (``core/sat/cdcl.py``),
  the one closure the port forks: the solver pool forks its CDCL workers,
  and a child forked after its parent started CUDA must never touch CUDA.
* ``opt-safety`` — no bare ``assert`` guarding runtime behaviour:
  ``python -O`` strips asserts, so guards must raise real exceptions.
* ``hash-determinism`` — no builtin ``hash()`` and no raw iteration over
  unordered sets inside the campaign canonicalizer or any
  ``*signature*`` function: canonical keys must be byte-stable across
  processes (``PYTHONHASHSEED``).
* ``cuda-wrapper`` — every kernel with an ``ops.py`` wrapper keeps its
  plain ``ref.py``, the kernels tree never mentions ``float64``, and no
  ``except`` under ``kernels/`` swallows a failure (each handler ends in
  ``raise``: a kernel launches or raises, it never falls back).

Legacy violations live in a checked-in baseline file
(``analysis/lint_baseline.txt``, empty); :func:`run_lint` reports *all*
findings and the CLI (``python -m repro_torch.analysis --check``) fails
only on findings whose fingerprint is not in the baseline.

The engine is self-contained stdlib (``ast`` + ``pathlib``): it never
imports the modules it scans, so it is safe to run in any environment,
including ones without torch.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["LintConfig", "LintFinding", "ParsedFile", "LintContext",
           "load_baseline", "run_lint", "write_baseline"]


# ---------------------------------------------------------------- config


@dataclass
class LintConfig:
    """Where to scan and how the rules bind to it.

    ``root`` is the repository root (or a fixture tree).  The tree read
    is ``root/src/repro_torch`` when that directory exists (paths and
    module names relative to ``root/src``, so they read
    ``repro_torch/...``), else ``root`` itself — so fixture trees under
    ``tests/fixtures/lint_torch/`` need no ``src/`` nesting, and the JAX
    package beside the port is never read.
    Rule scoping is *pattern-based* (module-name suffixes, path
    fragments) for the same reason: the defaults bind to both the real
    tree and the fixtures without per-tree configuration.
    """

    root: Path
    baseline_path: Optional[Path] = None
    rules: Optional[Sequence[str]] = None  # None -> all registered
    # fork-safety: entry modules are any module whose dotted name ends
    # with one of these suffixes; the closure over *module-scope*
    # imports (and the packages that hold each module) must not reach a
    # forbidden root.
    fork_entry_suffixes: Tuple[str, ...] = ("cdcl",)
    fork_forbidden_roots: Tuple[str, ...] = ("torch", "triton", "jax",
                                             "jaxlib", "optax", "flax")
    # hash-determinism: whole modules whose name ends with these
    # suffixes, plus any function whose name matches *signature* /
    # *canonical* anywhere in the tree.
    hash_module_suffixes: Tuple[str, ...] = ("campaign",)
    hash_func_fragments: Tuple[str, ...] = ("signature", "canonical")
    # cuda-wrapper: files whose scan-relative path contains this fragment
    kernels_path_fragment: str = "kernels/"

    def __post_init__(self) -> None:
        self.root = Path(self.root)
        if self.baseline_path is None:
            cand = self.scan_dir / "analysis" / "lint_baseline.txt"
            if cand.is_file():
                self.baseline_path = cand

    @property
    def scan_dir(self) -> Path:
        """The tree that is read."""
        port = self.root / "src" / "repro_torch"
        return port if port.is_dir() else self.root

    @property
    def scan_root(self) -> Path:
        """What paths and module names are relative to."""
        port = self.root / "src" / "repro_torch"
        return port.parent if port.is_dir() else self.root


# -------------------------------------------------------------- findings


@dataclass
class LintFinding:
    """One rule violation at one site."""

    rule: str
    path: str          # scan-root-relative, posix separators
    line: int
    message: str
    token: str = ""    # stable detail used for the fingerprint
    # disambiguator when (rule, path, token) repeats in one file; set
    # by run_lint() in file order so fingerprints stay stable.
    ordinal: int = 0

    @property
    def fingerprint(self) -> str:
        fp = f"{self.rule}:{self.path}:{self.token or self.line}"
        if self.ordinal:
            fp += f"#{self.ordinal}"
        return fp

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message}\n"
                f"    fingerprint: {self.fingerprint}")


@dataclass
class ParsedFile:
    path: Path
    rel: str                 # posix relative path under scan root
    module: str              # dotted module name
    tree: ast.AST
    source: str


@dataclass
class LintContext:
    """Everything a rule sees: parsed files + the module-scope import graph."""

    config: LintConfig
    files: Dict[str, ParsedFile]            # rel -> parsed
    modules: Dict[str, str] = field(default_factory=dict)  # module -> rel
    # module -> [(imported dotted name, lineno)] for imports executed at
    # import time (module scope and class bodies; not inside functions).
    module_scope_imports: Dict[str, List[Tuple[str, int]]] = \
        field(default_factory=dict)


# ------------------------------------------------------------- collection


def _module_name(rel: str) -> str:
    parts = rel[:-3].split("/")  # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _iter_py(scan_root: Path) -> Iterable[Path]:
    for p in sorted(scan_root.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        yield p


class _ImportScan(ast.NodeVisitor):
    """Collect imports executed at module import time.

    Function bodies are skipped (they run later, post-fork guards live
    there on purpose); class bodies are *not* skipped — they execute at
    import.
    """

    def __init__(self, module: str, is_pkg: bool) -> None:
        self.module = module
        self.is_pkg = is_pkg
        self.out: List[Tuple[str, int]] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return  # do not descend

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        return

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.out.append((alias.name, node.lineno))

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = node.module or ""
        if node.level:
            # resolve relative import against this module's package
            parts = self.module.split(".")
            # for a package __init__, level 1 is the package itself
            up = node.level - 1 if self.is_pkg else node.level
            if up:
                parts = parts[:-up] if up < len(parts) else []
            prefix = ".".join(parts)
            base = f"{prefix}.{base}" if base and prefix else (prefix or base)
        if base:
            self.out.append((base, node.lineno))
            # ``from pkg import sub`` may bind a submodule: record the
            # joined name too so the graph edge exists if it is one.
            for alias in node.names:
                if alias.name != "*":
                    self.out.append((f"{base}.{alias.name}", node.lineno))
        else:
            for alias in node.names:
                self.out.append((alias.name, node.lineno))


def build_context(config: LintConfig) -> LintContext:
    scan_root = config.scan_root
    files: Dict[str, ParsedFile] = {}
    for path in _iter_py(config.scan_dir):
        rel = path.relative_to(scan_root).as_posix()
        source = path.read_text()
        try:
            tree = ast.parse(source, filename=str(path))
        except SyntaxError as exc:  # surface as a finding, not a crash
            files[rel] = ParsedFile(path, rel, _module_name(rel),
                                    ast.Module(body=[], type_ignores=[]),
                                    source)
            files[rel].tree.lint_syntax_error = exc  # type: ignore[attr-defined]
            continue
        files[rel] = ParsedFile(path, rel, _module_name(rel), tree, source)

    ctx = LintContext(config=config, files=files)
    for rel, pf in files.items():
        ctx.modules[pf.module] = rel
        scan = _ImportScan(pf.module, rel.endswith("__init__.py"))
        scan.visit(pf.tree)
        ctx.module_scope_imports[pf.module] = scan.out
    return ctx


# ---------------------------------------------------------------- driver


def run_lint(config: LintConfig) -> List[LintFinding]:
    """Run every configured rule; return all findings (baselined or not)."""
    from .rules import ALL_RULES  # late import: rules import this module

    ctx = build_context(config)
    names = list(config.rules) if config.rules else list(ALL_RULES)
    findings: List[LintFinding] = []
    for name in names:
        if name not in ALL_RULES:
            raise KeyError(f"unknown lint rule: {name!r} "
                           f"(known: {sorted(ALL_RULES)})")
        findings.extend(ALL_RULES[name](ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.token))
    # assign ordinals so repeated (rule, path, token) fingerprints are
    # unique and stable in file order
    seen: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        key = (f.rule, f.path, f.token)
        f.ordinal = seen.get(key, 0)
        seen[key] = f.ordinal + 1
    return findings


# --------------------------------------------------------------- baseline


def load_baseline(path: Optional[Path]) -> Set[str]:
    """Read the suppression file: one fingerprint per line, ``#`` comments."""
    if path is None or not Path(path).is_file():
        return set()
    out: Set[str] = set()
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        out.add(line)
    return out


def write_baseline(path: Path, findings: Sequence[LintFinding]) -> None:
    lines = ["# repro_torch.analysis lint baseline — legacy violations only.",
             "# Each line is a finding fingerprint; new findings (not",
             "# listed here) fail `python -m repro_torch.analysis --check`.",
             "# Regenerate with: python -m repro_torch.analysis "
             "--write-baseline",
             ""]
    lines += sorted(f.fingerprint for f in findings)
    Path(path).write_text("\n".join(lines) + "\n")
