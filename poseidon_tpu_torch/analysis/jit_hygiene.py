"""Step-hygiene lint: host syncs, capture hazards, f64, profiler ranges
(the port's ``poseidon_tpu/analysis/jit_hygiene.py``, its rule IDs mapped
to what the port runs).

The port's step is eager PyTorch, captured into a CUDA graph under
``steps_per_dispatch`` > 1 and replayed; its loop overlaps only if
nothing in the dispatch window waits for the card; and the per-layer
attribution (``runtime/attribution.py``) stays honest only while the
``record_function`` ranges it joins on survive. All lexical, so lintable:

- **JIT101 host-sync-in-captured**: a host sync (``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``,
  ``np.asarray``/``np.array``) inside code that a CUDA graph captures or
  autograd replays: the ``forward``/``backward`` of a
  ``torch.autograd.Function``, the body of a ``with torch.cuda.graph(...)``
  block, a local function handed to ``checkpoint``/``checkpoint_layer``.
  Inside a capture a sync raises; in a replayed backward it stalls the
  card's queue mid-step.
- **JIT102 host-sync-in-window**: the same syncs, and ``float()``/
  ``int()`` of a computed value, inside the engine's dispatch window
  (``WINDOW_METHODS`` and what they reach intra-class or through
  module-level helpers): a sync there serializes the pipelined loop.
- **JIT103 capture-or-load-in-loop**: a CUDA graph capture
  (``torch.cuda.graph(...)``, ``CUDAGraph()``) or a kernel library
  ``load(...)``/``build_all(...)`` inside a loop body: each iteration
  captures or resolves anew.
- **JIT104 f64**: ``torch.float64``/``torch.double``, ``.double()``,
  ``np.float64``, ``astype("float64")``, ``dtype=float``: the card's f64
  rate is a fraction of f32's and every byte doubles.
- **JIT105 missing-range**: the ranges ``runtime/attribution.py`` joins
  on (``REQUIRED_SCOPES``, opened with ``scope(...)`` or
  ``record_function(...)``); a missing one moves its phase's device time
  into the ``(unattributed)`` row. ``core/net.py`` must open a range with
  a non-literal name (the per-layer ``scope(layer.name)``).
- **JIT106 checkpoint-body-range**: in ``REMAT_SCOPE_FILES`` a local
  function handed to ``checkpoint``/``checkpoint_layer`` must open a
  range itself: the ops recomputed in backward carry only the ranges
  inside the checkpointed body.

Pure ``ast``; imports nothing it lints.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import Finding, pragma_on_line, relpath

# method-call syncs: x.item(), x.cpu(), ...
SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
# attribute-path syncs rooted at numpy / torch aliases
SYNC_NP_FUNCS = {"asarray", "array"}
SYNC_TORCH_FUNCS = {"synchronize"}

# the engine's dispatch window: between two hard-sync boundaries these
# frames run every step (the train loop in Engine.train calls them)
WINDOW_METHODS: Dict[str, Set[str]] = {
    "poseidon_tpu_torch/runtime/engine.py": {
        "Engine._next_train_batch", "Engine._next_batch",
        "Engine._next_batch_stack", "Engine._chunk", "Engine._absorb",
        "Engine._check_divergence"},
    "poseidon_tpu_torch/runtime/metrics.py": {
        "AsyncScalarFetcher.put", "AsyncScalarFetcher.take_drained"},
    "poseidon_tpu_torch/data/pipeline.py": {"DevicePrefetcher.__next__"},
}

# the ranges runtime/attribution.py joins on (its EXTRA_SCOPES, and the
# per-layer range in core/net.py), by the module that opens them
REQUIRED_SCOPES: Dict[str, Tuple[str, ...]] = {
    "poseidon_tpu_torch/parallel/trainer.py": ("arena_pack",
                                               "optimizer_update"),
    "poseidon_tpu_torch/parallel/strategies.py": ("grad_sync",),
    "poseidon_tpu_torch/core/net.py": (),
}

# JIT106's scope: files whose checkpointed bodies are per-layer forwards
REMAT_SCOPE_FILES: Set[str] = {"poseidon_tpu_torch/core/net.py"}

_CHECKPOINT_CALLS = ("checkpoint", "checkpoint_layer")
_RANGE_CALLS = ("scope", "record_function")
_LOAD_CALLS = ("load", "build_all")


def _alias_map(tree: ast.Module) -> Dict[str, str]:
    """{local name: "np" | "torch" | "cuda"} for numpy / torch imports."""
    out: Dict[str, str] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                root = a.name.split(".")[0]
                if root == "numpy":
                    out[a.asname or root] = "np"
                elif root == "torch":
                    out[a.asname or root] = ("cuda" if a.asname and
                                             a.name == "torch.cuda"
                                             else "torch")
        elif isinstance(n, ast.ImportFrom) and n.module:
            if n.module == "numpy":
                for a in n.names:
                    if a.name in SYNC_NP_FUNCS:
                        out[a.asname or a.name] = "np_member"
            elif n.module == "torch":
                for a in n.names:
                    if a.name == "cuda":
                        out[a.asname or a.name] = "cuda"
    return out


def _root_of(node) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _chain(node) -> List[str]:
    """The dotted path of an attribute, its root name first
    (``torch.cuda.graph`` -> [torch, cuda, graph])."""
    out = []
    while isinstance(node, ast.Attribute):
        out.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        out.append(node.id)
    return out[::-1]


def _is_const(node) -> bool:
    return isinstance(node, ast.Constant) or (
        isinstance(node, ast.UnaryOp) and _is_const(node.operand))


def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


class _SyncFinder(ast.NodeVisitor):
    """Host-sync call sites within one body; ``scalars`` adds
    ``float()``/``int()`` of a computed value (host code only)."""

    def __init__(self, aliases: Dict[str, str], scalars: bool = False,
                 descend: bool = True):
        self.aliases = aliases
        self.scalars = scalars
        self.descend = descend
        self.hits: List[Tuple[int, str]] = []

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            canon = self.aliases.get(_root_of(f) or "", "")
            chain = _chain(f)
            if canon == "np" and f.attr in SYNC_NP_FUNCS:
                self.hits.append((node.lineno, f"np.{f.attr}"))
            elif f.attr in SYNC_TORCH_FUNCS and (
                    canon == "cuda" or (canon == "torch"
                                        and "cuda" in chain)):
                self.hits.append((node.lineno, "torch.cuda.synchronize"))
            elif f.attr in SYNC_METHODS and not node.args \
                    and canon not in ("np", "torch", "cuda"):
                self.hits.append((node.lineno, f".{f.attr}()"))
        elif isinstance(f, ast.Name):
            if self.scalars and f.id in ("float", "int") and \
                    len(node.args) == 1 and not _is_const(node.args[0]):
                self.hits.append((node.lineno, f"{f.id}()"))
            elif self.aliases.get(f.id) == "np_member":
                self.hits.append((node.lineno, f.id))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        if self.descend:
            self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def _fn_pragma(lines: Sequence[str], node, rule: str) -> bool:
    """``# static-ok: RULE`` on (or just above) a ``def`` line suppresses
    the rule for the whole function."""
    return any(pragma_on_line(lines, ln, rule)
               for ln in (node.lineno, node.lineno - 1))


def _function_index(tree: ast.Module) -> Dict[str, ast.AST]:
    """{qualname: FunctionDef} with Class.method / fn.<local> nesting."""
    out: Dict[str, ast.AST] = {}

    def walk(node, prefix):
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{ch.name}"
                out[q] = ch
                walk(ch, q + ".")
            elif isinstance(ch, ast.ClassDef):
                walk(ch, f"{prefix}{ch.name}.")
            else:
                walk(ch, prefix)

    walk(tree, "")
    return out


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any((isinstance(b, ast.Attribute) and b.attr == "Function"
                and "autograd" in _chain(b))
               or (isinstance(b, ast.Name) and b.id == "Function")
               for b in cls.bases)


def _resolve_local(index: Dict[str, ast.AST], scope: List[str],
                   name: str) -> Optional[str]:
    for enclosing in reversed(scope):
        q = f"{enclosing}.{name}"
        if q in index:
            return q
    return name if name in index else None


def _captured(tree: ast.Module, index: Dict[str, ast.AST]
              ) -> Tuple[Set[str], List[Tuple[str, ast.With]]]:
    """(qualnames of captured or replayed functions: autograd.Function
    forward/backward, local defs handed to a checkpoint, and what nests
    in them; the ``with torch.cuda.graph(...)`` blocks, by enclosing
    qualname)."""
    out: Set[str] = set()
    blocks: List[Tuple[str, ast.With]] = []
    by_node = {id(n): q for q, n in index.items()}

    class V(ast.NodeVisitor):
        def __init__(self):
            self.scope: List[str] = []
            self.cls: List[str] = []

        def visit_ClassDef(self, node):
            if _is_autograd_function(node):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef) and \
                            item.name in ("forward", "backward"):
                        q = by_node.get(id(item))
                        if q:
                            out.add(q)
            self.generic_visit(node)

        def visit_FunctionDef(self, node):
            self.scope.append(by_node.get(id(node), node.name))
            self.generic_visit(node)
            self.scope.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_With(self, node):
            for item in node.items:
                e = item.context_expr
                if isinstance(e, ast.Call) and _call_name(e) == "graph" \
                        and "cuda" in _chain(e.func):
                    blocks.append((self.scope[-1] if self.scope
                                   else "<module>", node))
            self.generic_visit(node)

        def visit_Call(self, node):
            if _call_name(node) in _CHECKPOINT_CALLS and node.args and \
                    isinstance(node.args[0], ast.Name):
                q = _resolve_local(index, self.scope, node.args[0].id)
                if q is not None:
                    out.add(q)
            self.generic_visit(node)

    V().visit(tree)
    for q in list(index):
        for t in list(out):
            if q.startswith(t + "."):
                out.add(q)
    return out, blocks


def _range_names(tree: ast.Module) -> Tuple[Set[str], bool]:
    """(literal/prefix range names, saw a range with a non-literal
    name)."""
    names: Set[str] = set()
    dynamic = False
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Call) and n.args
                and _call_name(n) in _RANGE_CALLS):
            continue
        a = n.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            names.add(a.value)
        elif isinstance(a, ast.JoinedStr):
            if a.values and isinstance(a.values[0], ast.Constant):
                names.add(str(a.values[0].value))
            else:
                dynamic = True
        else:
            dynamic = True
    return names, dynamic


def lint_file(path: str, source: Optional[str] = None,
              tree: Optional[ast.Module] = None) -> List[Finding]:
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    if tree is None:                 # run_lints hands in a shared parse
        try:
            tree = ast.parse(source)
        except SyntaxError:
            return []        # threads.py already reports THR000
    rel = relpath(path)
    lines = source.splitlines()
    aliases = _alias_map(tree)
    index = _function_index(tree)
    findings: List[Finding] = []

    # ---- JIT101: host sync inside captured or replayed code ------------ #
    captured, blocks = _captured(tree, index)
    for q in sorted(captured):
        node = index[q]
        if _fn_pragma(lines, node, "JIT101"):
            continue
        sf = _SyncFinder(aliases, descend=False)
        sf.visit(ast.Module(body=list(node.body), type_ignores=[]))
        for line, what in sf.hits:
            findings.append(Finding(
                rule="JIT101", path=rel, line=line, symbol=q, key=what,
                message=f"{what} inside {q!r}, which a CUDA graph "
                        f"captures or autograd replays: a host sync "
                        f"raises inside a capture and stalls the card's "
                        f"queue mid-step"))
    for q, block in blocks:
        sf = _SyncFinder(aliases, descend=False)
        sf.visit(ast.Module(body=list(block.body), type_ignores=[]))
        for line, what in sf.hits:
            findings.append(Finding(
                rule="JIT101", path=rel, line=line, symbol=q,
                key=f"graph:{what}",
                message=f"{what} inside a torch.cuda.graph capture "
                        f"block: a host sync raises inside a capture"))

    # ---- JIT102: host sync inside the dispatch window ------------------ #
    window = WINDOW_METHODS.get(rel)
    if window:
        for q in sorted(window):
            if q not in index:
                findings.append(Finding(
                    rule="JIT102", path=rel, line=1, symbol="<module>",
                    key=f"missing:{q}",
                    message=f"configured dispatch-window method {q!r} no "
                            f"longer resolves — update WINDOW_METHODS or "
                            f"the host-sync gate goes blind for it"))
        reach: Set[str] = set()
        work = [q for q in window if q in index]
        while work:
            q = work.pop()
            if q in reach:
                continue
            reach.add(q)
            cls_prefix = q.rsplit(".", 1)[0] + "." if "." in q else ""
            for n in ast.walk(index[q]):
                if not isinstance(n, ast.Call):
                    continue
                callee = None
                if isinstance(n.func, ast.Attribute) and \
                        isinstance(n.func.value, ast.Name) and \
                        n.func.value.id == "self":
                    callee = cls_prefix + n.func.attr
                elif isinstance(n.func, ast.Name):
                    callee = n.func.id          # module-level helper
                if callee and callee in index and callee not in reach:
                    work.append(callee)
        for q in sorted(reach):
            node = index[q]
            if _fn_pragma(lines, node, "JIT102"):
                continue
            sf = _SyncFinder(aliases, scalars=True)
            sf.visit(ast.Module(body=list(node.body), type_ignores=[]))
            for line, what in sf.hits:
                findings.append(Finding(
                    rule="JIT102", path=rel, line=line, symbol=q, key=what,
                    message=f"{what} reachable inside the dispatch window "
                            f"(via {q!r}): a host sync here serializes "
                            f"the pipelined train loop"))

    # ---- JIT103: a capture or a kernel load inside a loop -------------- #
    class LoopScan(ast.NodeVisitor):
        def __init__(self):
            self.loops = 0

        def visit_For(self, node):
            self.loops += 1
            self.generic_visit(node)
            self.loops -= 1

        visit_While = visit_For

        def visit_FunctionDef(self, node):
            saved, self.loops = self.loops, 0
            self.generic_visit(node)
            self.loops = saved

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node):
            name = _call_name(node)
            chain = _chain(node.func)
            if self.loops:
                if (name == "graph" and "cuda" in chain) or \
                        name == "CUDAGraph":
                    findings.append(Finding(
                        rule="JIT103", path=rel, line=node.lineno,
                        symbol="<loop>", key="capture-in-loop",
                        message="a CUDA graph captured inside a loop body: "
                                "every iteration captures anew"))
                elif name in _LOAD_CALLS and "_build" in chain:
                    findings.append(Finding(
                        rule="JIT103", path=rel, line=node.lineno,
                        symbol="<loop>", key="load-in-loop",
                        message="a kernel library load inside a loop "
                                "body: resolve the libraries once, "
                                "outside the loop"))
            self.generic_visit(node)

    LoopScan().visit(tree)

    # ---- JIT104: f64 --------------------------------------------------- #
    for n in ast.walk(tree):
        if isinstance(n, ast.Attribute) and n.attr in ("float64", "double") \
                and aliases.get(_root_of(n) or "") in ("np", "torch"):
            findings.append(Finding(
                rule="JIT104", path=rel, line=n.lineno, symbol="<module>",
                key="float64",
                message="explicit float64 dtype: the card's f64 rate is a "
                        "fraction of f32's and every byte doubles"))
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "double" and not n.args:
            findings.append(Finding(
                rule="JIT104", path=rel, line=n.lineno, symbol="<module>",
                key="double",
                message=".double(): an f64 copy of the tensor"))
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "astype" and n.args and \
                isinstance(n.args[0], ast.Constant) and \
                n.args[0].value in ("float64", "f64", "double"):
            findings.append(Finding(
                rule="JIT104", path=rel, line=n.lineno, symbol="<module>",
                key="astype-f64",
                message="astype('float64'): accidental double-precision "
                        "promotion"))
        elif isinstance(n, ast.keyword) and n.arg == "dtype" and \
                isinstance(n.value, ast.Name) and n.value.id == "float":
            findings.append(Finding(
                rule="JIT104", path=rel, line=n.value.lineno,
                symbol="<module>", key="dtype-float",
                message="dtype=float is float64 on the host"))

    # ---- JIT105: the required ranges ----------------------------------- #
    req = REQUIRED_SCOPES.get(rel)
    if req is not None:
        present, dynamic = _range_names(tree)
        if rel.endswith("core/net.py") and not dynamic:
            findings.append(Finding(
                rule="JIT105", path=rel, line=1, symbol="<module>",
                key="layer-scope",
                message="the per-layer scope(layer.name) range is gone: "
                        "per-layer device-time attribution joins on it"))
        for name in req:
            if not any(p == name or p.startswith(name) for p in present):
                findings.append(Finding(
                    rule="JIT105", path=rel, line=1, symbol="<module>",
                    key=name,
                    message=f"required range {name!r} missing: its device "
                            f"time falls into the attribution table's "
                            f"(unattributed) row"))

    # ---- JIT106: checkpointed bodies keep their range ------------------ #
    if rel in REMAT_SCOPE_FILES:
        class Ckpt(ast.NodeVisitor):
            def __init__(self):
                self.scope: List[str] = []

            def visit_FunctionDef(self, node):
                self.scope.append({id(v): k for k, v in index.items()}
                                  .get(id(node), node.name))
                self.generic_visit(node)
                self.scope.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Call(self, node):
                if _call_name(node) in _CHECKPOINT_CALLS and node.args \
                        and isinstance(node.args[0], ast.Name):
                    q = _resolve_local(index, self.scope, node.args[0].id)
                    if q is not None and not any(
                            isinstance(c, ast.Call)
                            and _call_name(c) in _RANGE_CALLS
                            for c in ast.walk(index[q])):
                        findings.append(Finding(
                            rule="JIT106", path=rel, line=node.lineno,
                            symbol=q, key=node.args[0].id,
                            message=f"checkpointed body "
                                    f"{node.args[0].id!r} opens no range: "
                                    f"the ops recomputed in backward "
                                    f"carry only the ranges inside it, so "
                                    f"the layer's recompute time falls "
                                    f"into the (unattributed) row"))
                self.generic_visit(node)

        Ckpt().visit(tree)

    return findings


def required_scope_files() -> Sequence[str]:
    return tuple(REQUIRED_SCOPES)
