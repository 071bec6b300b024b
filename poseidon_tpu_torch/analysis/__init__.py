"""Static guardrails of the port: concurrency lint, step-hygiene lint,
wire-schema lint, the protocol model checker and the step contracts (the
port's ``poseidon_tpu/analysis``).

- ``threads.py`` — AST concurrency lint over the port's threaded modules
  (the engine's dispatch window, the prefetcher, the async snapshot
  writer, the batcher, the fleet, the reloader, the async tier's client
  and service): thread entrypoints, per-class lock discipline,
  unsynchronized shared mutation, lock-order cycles, check-then-act, CUDA
  from a thread outside the sanctioned modules (THR001-THR006).
- ``jit_hygiene.py`` — host syncs inside captured or replayed code
  (``autograd.Function`` bodies, CUDA graph captures, checkpointed
  bodies) and in the engine's dispatch window, graph captures and kernel
  loads inside loops, float64, the ``record_function`` ranges the
  attribution joins on (JIT101-JIT106).
- ``contracts.py`` — per-model goldens of one train step read off the
  dispatcher (``contracts/*.json``): the DWBP all-reduces, the layout
  conversions, in-place arena updates, the dtype census, the SPMD
  collective schedule planned against recorded, and the cross-participant
  consistency gate.
- ``protocol.py`` — wire-schema lint (PROTO201-PROTO207) of the port's
  socket tiers, and the schema golden ``protocol_schema.json``, which
  must equal the JAX package's kind for kind (the two interoperate).
- ``model_check.py`` — the exhaustive bounded model checker of the
  SSP/managed-communication protocol, with seeded-mutation self-tests.

Findings carry ``file:line`` + rule id and a line-number-free
fingerprint; ``baseline.json`` grandfathers findings, each with its
reason, so a run fails only on NEW ones. An intentional finding is
suppressed in place with a ``# static-ok: RULE`` comment on its line.

The lints are pure ``ast`` walks and import nothing they lint;
``python -m poseidon_tpu_torch.analysis`` is cheap enough for a
pre-commit hook. Only ``--contracts`` and ``--collectives`` import torch.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = [
    "Finding", "load_baseline", "save_baseline", "filter_new",
    "stale_baseline",
    "run_lints", "default_targets", "iter_python_files", "REPO_ROOT",
]

# the repo root this package is checked into (…/poseidon_tpu_torch/
# analysis -> two levels up); every finding path is reported relative to
# it so fingerprints are machine-independent
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")


@dataclass(frozen=True)
class Finding:
    """One lint finding. ``key`` disambiguates findings within a symbol
    (the attribute, lock pair, or callee involved); the fingerprint
    deliberately excludes the line number and message so baselines survive
    unrelated edits to the same file."""

    rule: str          # e.g. THR004
    path: str          # repo-relative, forward slashes
    line: int
    symbol: str        # Class.method / function qualname / "<module>"
    message: str
    key: str = ""      # attr name / lock-cycle / callee — fingerprint salt

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}:{self.key}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} [{self.symbol}] "
                f"{self.message}")


def relpath(path: str) -> str:
    """Repo-relative forward-slash path (the fingerprint convention)."""
    ap = os.path.abspath(path)
    if ap.startswith(REPO_ROOT + os.sep):
        ap = ap[len(REPO_ROOT) + 1:]
    return ap.replace(os.sep, "/")


# --------------------------------------------------------------------------- #
# pragma suppression
# --------------------------------------------------------------------------- #

def pragma_on_line(source_lines: Sequence[str], ln: int,
                   rule: str) -> bool:
    """One line's ``# static-ok:`` grammar — the single home for it (the
    def-level pragma in jit_hygiene reuses this per-line check)."""
    if not 1 <= ln <= len(source_lines):
        return False
    text = source_lines[ln - 1]
    if "# static-ok:" not in text:
        return False
    rules = text.split("# static-ok:", 1)[1].split("#")[0]
    allowed = {r.strip() for r in rules.split(",")}
    return "*" in allowed or rule in allowed


def pragma_suppressed(source_lines: Sequence[str], finding: Finding,
                      tree: Optional[ast.Module] = None) -> bool:
    """``# static-ok: THR004`` (or ``# static-ok: *``) on the finding line
    — or the line above it — suppresses the finding in place; on (or just
    above) an enclosing ``def`` line it suppresses the rule for the whole
    function. For load-bearing intentional sites (the documented sync
    point in ``scalar_rows``) this beats a baseline entry: the
    justification lives next to the code it excuses and dies with it."""
    if any(pragma_on_line(source_lines, ln, finding.rule)
           for ln in (finding.line, finding.line - 1)):
        return True
    if tree is not None:
        for n in ast.walk(tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and n.lineno <= finding.line <= (n.end_lineno
                                                     or n.lineno):
                if any(pragma_on_line(source_lines, ln, finding.rule)
                       for ln in (n.lineno, n.lineno - 1)):
                    return True
    return False


# --------------------------------------------------------------------------- #
# baseline
# --------------------------------------------------------------------------- #

def load_baseline(path: Optional[str] = None) -> Dict[str, str]:
    """{fingerprint: reason}. A missing file is an empty baseline."""
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        doc = json.load(f)
    return {e["fingerprint"]: e.get("reason", "")
            for e in doc.get("findings", [])}


def save_baseline(findings: Iterable[Finding],
                  reasons: Optional[Dict[str, str]] = None,
                  path: Optional[str] = None) -> str:
    """Write the grandfather list (sorted, one entry per fingerprint).
    ``reasons`` carries over justifications for fingerprints that stay."""
    path = path or BASELINE_PATH
    reasons = reasons or {}
    entries = {}
    for f in findings:
        entries.setdefault(f.fingerprint, {
            "fingerprint": f.fingerprint,
            "rule": f.rule,
            "where": f"{f.path}:{f.line}",
            "reason": reasons.get(f.fingerprint, ""),
        })
    doc = {"comment": "Grandfathered static-analysis findings: CI fails "
                      "only on NEW fingerprints. Shrink this list; never "
                      "grow it without review.",
           "findings": sorted(entries.values(),
                              key=lambda e: e["fingerprint"])}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")
    return path


def filter_new(findings: Sequence[Finding],
               baseline: Dict[str, str]) -> List[Finding]:
    return [f for f in findings if f.fingerprint not in baseline]


def stale_baseline(findings: Optional[Sequence[Finding]] = None,
                   path: Optional[str] = None) -> List[str]:
    """What is wrong with the grandfather list: entries without a reason,
    and entries whose finding no longer fires (repaired: drop them).
    Empty when the list is clean."""
    findings = run_lints() if findings is None else findings
    fired = {f.fingerprint for f in findings}
    out = []
    for fp, reason in sorted(load_baseline(path).items()):
        if not reason.strip():
            out.append(f"{fp}: no reason given")
        if fp not in fired:
            out.append(f"{fp}: no longer fires")
    return out


# --------------------------------------------------------------------------- #
# target discovery + driver
# --------------------------------------------------------------------------- #

# Scripts outside the package that import the threaded runtime ride the
# same lint: a race added there is as real as one inside the package.
# The port's has none yet.
EXTRA_SCRIPT_TARGETS: tuple = ()


def default_targets() -> List[str]:
    pkg = os.path.dirname(os.path.abspath(__file__))          # .../analysis
    targets = [os.path.dirname(pkg)]                          # the package
    targets.extend(os.path.join(REPO_ROOT, rel)
                   for rel in EXTRA_SCRIPT_TARGETS)
    return targets


def iter_python_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def run_lints(paths: Optional[Sequence[str]] = None,
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run both AST lints over ``paths`` (files or directories; default =
    the package + the instrumented scripts). Pragma-suppressed findings
    are dropped here; baseline filtering is the caller's move."""
    from . import jit_hygiene, threads
    targets = list(paths) if paths is not None else default_targets()
    files = iter_python_files(targets)
    findings: List[Finding] = []
    # a configured .py target that vanished must SURFACE (the
    # WINDOW_METHODS pattern): a renamed script silently dropping out of
    # coverage is the stale-config blindness this package exists to stop
    for t in targets:
        if t.endswith(".py") and not os.path.exists(t):
            findings.append(Finding(
                rule="CFG001", path=relpath(t), line=1, symbol="<config>",
                key="missing-target",
                message="configured lint target no longer exists — "
                        "update EXTRA_SCRIPT_TARGETS (or the caller's "
                        "path list) or the file rides unlinted"))
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError):
            continue
        lines = source.splitlines()
        per_file: List[Finding] = []
        try:
            tree = ast.parse(source)   # ONE parse feeds both linters
        except SyntaxError as e:
            per_file.append(Finding(
                rule="THR000", path=relpath(path), line=e.lineno or 1,
                symbol="<module>", message=f"syntax error: {e.msg}",
                key="syntax"))
            tree = None
        if tree is not None:
            per_file.extend(threads.lint_file(path, source, tree=tree))
            per_file.extend(jit_hygiene.lint_file(path, source, tree=tree))
        findings.extend(f for f in per_file
                        if not pragma_suppressed(lines, f, tree=tree))
    if paths is None:
        # the wire-schema lint is CROSS-file (dispatchers in one module,
        # senders in another), so it runs against its own configured
        # service specs rather than per file — but only on the default
        # sweep: restricting the lint to explicit paths must not drag in
        # findings about files the caller did not ask about. Its
        # findings share the fingerprint/baseline/pragma machinery.
        from . import protocol
        findings.extend(protocol.run_protocol_lint())
    if rules:
        # infrastructure findings (vanished target, unparseable file)
        # survive any --rules restriction — a rule-filtered hook must
        # not re-open the silent-coverage-loss hole CFG001 exists for
        keep = set(rules) | {"CFG001", "THR000"}
        findings = [f for f in findings if f.rule in keep]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
