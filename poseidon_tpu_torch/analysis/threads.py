"""Concurrency lint: races, lock-order cycles, and thread-unsafety idioms
(the port's ``poseidon_tpu/analysis/threads.py``, over the port's threaded
modules).

A pure-AST pass (no imports of the linted code) over every class that
either spawns a thread (``threading.Thread(target=...)``) or owns a lock
(an attribute assigned ``threading.Lock/RLock/Condition`` in ``__init__``).
For each such class it reconstructs:

- **thread entrypoints** — methods (or method-local functions) passed as a
  Thread target, plus everything reachable from them through ``self.m()``
  calls (the thread-side call graph);
- **caller-side methods** — the public surface (non-underscore methods and
  the iterator/context dunders) plus everything it reaches. A method can
  be on both sides (a poll method called from the watch thread AND a
  server op), which is exactly when its accesses race with themselves;
- **lock discipline** — which of the class's locks are held, lexically, at
  every ``self.<attr>`` access. Private helpers whose every intra-class
  call site holds a lock inherit that lock ("caller holds the lock"
  helpers), computed as an intersection-over-call-sites fixpoint.

Rules:

- **THR001 unsynchronized-shared-state**: an attribute mutated on the
  thread side and accessed on the caller side (or mutated from both) with
  no single lock common to all its accesses, where at least one mutation
  holds no lock at all. Assign / subscript-store / container-mutator form.
- **THR002 lock-order-cycle**: the class's lock-acquisition-order graph
  (nested ``with`` regions + locks acquired by callees while the caller
  holds another) contains a cycle — or a plain ``Lock`` is re-acquired
  while already held (self-deadlock).
- **THR003 check-then-act**: an ``if`` whose test reads a shared attribute
  and whose body mutates the same attribute, with no lock held — the
  classic lost-update window on shared dicts/sets.
- **THR004 unlocked-counter-increment**: the ``+=`` special case of
  THR001, split out because read-modify-write on telemetry counters is
  the race this repo has actually shipped (batcher flush counters,
  reloader failure counters, client reconnect counter).
- **THR005 cuda-in-thread**: CUDA touched (a ``torch.cuda.*`` call, a
  ``.cuda()`` or ``.record_stream()`` call) from a thread entrypoint's
  call graph outside the sanctioned modules (``SANCTIONED_CUDA_THREAD_
  MODULES``, each with its reason); CUDA work from anywhere else races
  the train thread's streams.
- **THR006 mixed-lock-discipline**: the same attribute is mutated both
  under a lock and with no lock somewhere else in the class — whichever
  side is right, one of them is wrong. Fires even when the thread/caller
  split can't be established (lock-owning classes whose threads live
  elsewhere).

Soundness posture: per-class, lexical, intentionally modest. Cross-object
races (engine vs. fetcher) and aliased locks are out of scope; attributes
whose only writes happen in ``__init__`` are treated as
published-before-start. False positives are suppressed in place with
``# static-ok: RULE`` or grandfathered in ``baseline.json``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import Finding, relpath

# attribute types (by constructor name in __init__) that make an attr a lock
LOCK_TYPES = {"Lock", "RLock", "Condition"}
# attr types that are internally synchronized — their methods are not races
SAFE_TYPES = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
              "Event", "Semaphore", "BoundedSemaphore", "Barrier", "local"}
# container methods that mutate the receiver
MUTATOR_METHODS = {"append", "appendleft", "add", "pop", "popleft",
                   "remove", "discard", "clear", "update", "extend",
                   "insert", "setdefault", "popitem"}
# modules blessed to touch CUDA off the main thread (THR005), each with
# its reason
SANCTIONED_CUDA_THREAD_MODULES = {
    # DevicePrefetcher: the host-to-device copies of the next batches on
    # its own stream, the whole point of the stage
    "poseidon_tpu_torch/data/pipeline.py",
    # AsyncScalarFetcher: the drain of a step's metrics to host floats
    # waits on their copy's event on its thread
    "poseidon_tpu_torch/runtime/metrics.py",
}

CALLER_DUNDERS = {"__next__", "__iter__", "__call__", "__enter__",
                  "__exit__", "__len__", "__contains__", "__getitem__",
                  "__setitem__"}

READ, WRITE, AUGWRITE, MUTCALL = "read", "write", "augwrite", "mutcall"


@dataclass
class Access:
    attr: str
    kind: str                  # read | write | augwrite | mutcall
    line: int
    locks: frozenset           # lock attr names lexically held
    method: str                # qualname within the class


@dataclass
class MethodRec:
    name: str                              # qualname (m or m.<local>f)
    node: ast.AST
    is_public: bool
    accesses: List[Access] = field(default_factory=list)
    # (callee qualname, locks held at the call site, line)
    calls: List[Tuple[str, frozenset, int]] = field(default_factory=list)
    # (lock acquired, locks lexically held just before, line)
    acquires: List[Tuple[str, frozenset, int]] = field(default_factory=list)
    # lock attrs this method acquires anywhere (for call-edge lock flow)
    own_locks: Set[str] = field(default_factory=set)
    thread_targets: Set[str] = field(default_factory=set)
    uses_cuda: List[int] = field(default_factory=list)  # lines of CUDA calls
    # If-statements: (line, locks, attrs read in test, attrs mutated in body)
    check_then_act: List[Tuple[int, frozenset, Set[str], Set[str]]] = \
        field(default_factory=list)


class _MethodScanner(ast.NodeVisitor):
    """Walk one method (and its nested functions, as separate records)."""

    def __init__(self, cls: "_ClassInfo", qualname: str, node, torch_aliases):
        self.cls = cls
        # nested functions (qualname contains ".") are never public roots:
        # they are reachable only through edges from their enclosing
        # method (direct call, callback argument, or Thread target)
        self.rec = MethodRec(
            name=qualname, node=node,
            is_public=("." not in qualname
                       and (not qualname.startswith("_")
                            or qualname in CALLER_DUNDERS)))
        cls.methods[qualname] = self.rec
        self.torch_aliases = torch_aliases
        self._locks: Tuple[str, ...] = ()
        self._local_funcs: Set[str] = set()
        # scan for local defs first so Thread(target=localfn) resolves
        for ch in ast.walk(node):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and ch is not node:
                self._local_funcs.add(ch.name)
        for stmt in node.body:
            self.visit(stmt)

    # ---- helpers ----------------------------------------------------- #
    def _held(self) -> frozenset:
        return frozenset(self._locks)

    def _self_attr(self, node) -> Optional[str]:
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        return None

    def _record(self, attr: str, kind: str, line: int) -> None:
        if attr in self.cls.lock_attrs or attr in self.cls.safe_attrs:
            return
        if attr in self.cls.method_names:
            return                      # bound-method reference, not data
        self.rec.accesses.append(Access(attr, kind, line, self._held(),
                                        self.rec.name))

    # ---- nested functions: separate pseudo-methods -------------------- #
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        qual = f"{self.rec.name}.{node.name}"
        _MethodScanner(self.cls, qual, node, self.torch_aliases)
        # defining is not calling; an explicit Call adds the edge below

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.generic_visit(node)

    # ---- lock regions -------------------------------------------------- #
    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            attr = self._self_attr(item.context_expr)
            if attr is not None and attr in self.cls.lock_attrs:
                # extend _locks PER ITEM: in `with self._a, self._b:`
                # the second acquire happens with the first held, so it
                # must record the _a -> _b order edge exactly like the
                # nested-with spelling
                self.rec.acquires.append((attr, self._held(),
                                          item.context_expr.lineno))
                self.rec.own_locks.add(attr)
                self._locks = self._locks + (attr,)
                acquired.append(attr)
            else:
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        # pop THIS statement's items BY NAME (last occurrence each, like
        # .release()): an unbalanced .acquire() in the body must survive
        # the with-exit instead of being popped in place of the with's own
        # lock, or every later access is credited with the wrong lock
        for attr in reversed(acquired):
            self._pop_lock(attr)

    def _pop_lock(self, attr: str) -> None:
        """Drop the LAST held occurrence of ``attr`` — shared by with-exit
        and ``.release()`` so the two spellings can't desynchronize."""
        if attr in self._locks:
            i = len(self._locks) - 1 - self._locks[::-1].index(attr)
            self._locks = self._locks[:i] + self._locks[i + 1:]

    # ---- accesses ------------------------------------------------------ #
    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._store_target(t)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        # `self.count: int = v` stores exactly like the plain spelling
        # (a bare `self.count: int` with no value stores nothing)
        if node.value is not None:
            self._store_target(node.target)
            self.visit(node.value)

    def _store_target(self, t) -> None:
        attr = self._self_attr(t)
        if attr is not None:
            self._record(attr, WRITE, t.lineno)
            return
        if isinstance(t, ast.Subscript):
            attr = self._self_attr(t.value)
            if attr is not None:
                self._record(attr, WRITE, t.lineno)
                self.visit(t.slice)
                return
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._store_target(el)
            return
        self.visit(t)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = self._self_attr(node.target)
        if attr is not None:
            self._record(attr, AUGWRITE, node.lineno)
        elif isinstance(node.target, ast.Subscript):
            sub = self._self_attr(node.target.value)
            if sub is not None:
                self._record(sub, AUGWRITE, node.lineno)
            self.visit(node.target.slice)
        else:
            self.visit(node.target)
        self.visit(node.value)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self._self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._record(attr, READ, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        # self.m(...) — intra-class call edge
        attr = self._self_attr(func)
        if attr is not None and attr in self.cls.method_names:
            self.rec.calls.append((attr, self._held(), node.lineno))
        # self.x.mutator(...) — container mutation
        if isinstance(func, ast.Attribute):
            recv = self._self_attr(func.value)
            if recv is not None and func.attr in MUTATOR_METHODS:
                self._record(recv, MUTCALL, node.lineno)
            # self._lock.acquire() counts for the order graph AND credits
            # the lock lexically until its .release() — the
            # acquire/try/finally/release idiom is as locked as `with`
            # (visitation follows source order, so the extent is right
            # for the standard spelling; a conditional acquire
            # over-credits its else-branch, which this lint accepts)
            if recv is not None and recv in self.cls.lock_attrs:
                if func.attr == "acquire":
                    self.rec.acquires.append((recv, self._held(),
                                              node.lineno))
                    self.rec.own_locks.add(recv)
                    self._locks = self._locks + (recv,)
                elif func.attr == "release":
                    self._pop_lock(recv)
        # localfn(...) — edge to a nested function of this method chain
        if isinstance(func, ast.Name) and func.id in self._local_funcs:
            self.rec.calls.append((f"{self.rec.name}.{func.id}",
                                   self._held(), node.lineno))
        # callbacks: a local function or bound method passed as an
        # argument is assumed to be invoked by the callee (retry helpers,
        # executors) — the edge keeps its accesses on the caller's side
        # of the thread split instead of unreachable. The edge carries NO
        # held locks: the callback runs whenever the callee decides, not
        # under the locks held at the registration site, so it must not
        # feed "caller holds the lock" inheritance.
        for arg in list(node.args) + [kw.value for kw in node.keywords
                                      if kw.arg != "target"]:
            if isinstance(arg, ast.Name) and arg.id in self._local_funcs:
                self.rec.calls.append((f"{self.rec.name}.{arg.id}",
                                       frozenset(), node.lineno))
            else:
                m_attr = self._self_attr(arg)
                if m_attr is not None and m_attr in self.cls.method_names:
                    self.rec.calls.append((m_attr, frozenset(),
                                           node.lineno))
        # torch.cuda.<...>(...), x.cuda(), x.record_stream(s) from a
        # thread would race the train thread's streams
        root, chain = func, []
        while isinstance(root, ast.Attribute):
            chain.append(root.attr)
            root = root.value
        if (isinstance(root, ast.Name)
                and self.torch_aliases.get(root.id) is not None
                and (self.torch_aliases[root.id] or "cuda" in chain[1:])) \
                or (isinstance(func, ast.Attribute)
                    and func.attr in ("cuda", "record_stream")):
            self.rec.uses_cuda.append(node.lineno)
        # Thread(target=...)
        callee = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if callee == "Thread":
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                t_attr = self._self_attr(kw.value)
                if t_attr is not None:
                    self.rec.thread_targets.add(t_attr)
                elif isinstance(kw.value, ast.Name) and \
                        kw.value.id in self._local_funcs:
                    self.rec.thread_targets.add(
                        f"{self.rec.name}.{kw.value.id}")
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        test_reads = {a for n in ast.walk(node.test)
                      for a in [self._self_attr(n)] if a}
        body_muts: Set[str] = set()
        for stmt in node.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        a = self._self_attr(t) or (
                            self._self_attr(t.value)
                            if isinstance(t, ast.Subscript) else None)
                        if a:
                            body_muts.add(a)
                elif isinstance(n, ast.AugAssign):
                    a = self._self_attr(n.target)
                    if a:
                        body_muts.add(a)
                elif isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute):
                    recv = self._self_attr(n.func.value)
                    if recv and n.func.attr in MUTATOR_METHODS:
                        body_muts.add(recv)
        overlap = {a for a in (test_reads & body_muts)
                   if a not in self.cls.lock_attrs
                   and a not in self.cls.safe_attrs}
        if overlap:
            self.rec.check_then_act.append(
                (node.lineno, self._held(), test_reads, overlap))
        self.generic_visit(node)


class _ClassInfo:
    def __init__(self, node: ast.ClassDef, path: str, torch_aliases):
        self.node = node
        self.name = node.name
        self.path = path
        self.lock_attrs: Set[str] = set()
        self.reentrant_locks: Set[str] = set()   # RLock / Condition attrs
        self.safe_attrs: Set[str] = set()
        self.public_attrs: Set[str] = set()     # assigned in __init__, public
        self.method_names: Set[str] = {
            n.name for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.methods: Dict[str, MethodRec] = {}
        self._classify_init()
        for n in node.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _MethodScanner(self, n.name, n, torch_aliases)

    def _classify_init(self) -> None:
        init = next((n for n in self.node.body
                     if isinstance(n, ast.FunctionDef)
                     and n.name == "__init__"), None)
        if init is None:
            return
        for n in ast.walk(init):
            # plain and annotated assignment both declare attributes
            # (self._lock: threading.Lock = threading.Lock())
            if isinstance(n, ast.Assign):
                targets, value = n.targets, n.value
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                targets, value = [n.target], n.value
            else:
                continue
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                if not t.attr.startswith("_"):
                    self.public_attrs.add(t.attr)
                v = value
                if isinstance(v, ast.Call):
                    f = v.func
                    ctor = f.attr if isinstance(f, ast.Attribute) else (
                        f.id if isinstance(f, ast.Name) else "")
                    if ctor in LOCK_TYPES:
                        self.lock_attrs.add(t.attr)
                        # default Condition() wraps an RLock; only a
                        # plain Lock self-deadlocks on re-acquisition
                        if ctor in ("RLock", "Condition"):
                            self.reentrant_locks.add(t.attr)
                    elif ctor in SAFE_TYPES:
                        self.safe_attrs.add(t.attr)

    # ---- call-graph closures ------------------------------------------ #
    def entries(self) -> Set[str]:
        out: Set[str] = set()
        for m in self.methods.values():
            out |= {t for t in m.thread_targets if t in self.methods}
        return out

    def closure(self, roots: Set[str]) -> Set[str]:
        seen = set(r for r in roots if r in self.methods)
        work = list(seen)
        while work:
            m = work.pop()
            for callee, _, _ in self.methods[m].calls:
                if callee in self.methods and callee not in seen:
                    seen.add(callee)
                    work.append(callee)
        return seen

    def context_locks(self) -> Dict[str, frozenset]:
        """Locks a method can assume held because EVERY intra-class call
        site holds them ("caller holds the lock" helpers). Public methods
        and thread entrypoints assume nothing (external callers)."""
        entries = self.entries()
        sites: Dict[str, List[Tuple[str, frozenset]]] = {}
        for m in self.methods.values():
            for callee, locks, _ in m.calls:
                sites.setdefault(callee, []).append((m.name, locks))
        ctx: Dict[str, frozenset] = {m: frozenset()
                                     for m in self.methods}
        TOP = None  # lattice top: no constraint yet
        pend = {m: TOP for m in self.methods}
        for m, rec in self.methods.items():
            if rec.is_public or m in entries or m not in sites:
                pend[m] = frozenset()
        for _ in range(len(self.methods) + 2):
            changed = False
            for m, rec in self.methods.items():
                if pend[m] == frozenset() and (rec.is_public or
                                               m in entries or
                                               m not in sites):
                    continue
                acc = TOP
                for caller, locks in sites.get(m, []):
                    inherit = pend.get(caller)
                    eff = locks | (inherit if inherit not in (None,)
                                   else frozenset())
                    acc = eff if acc is None else (acc & eff)
                acc = acc if acc is not None else frozenset()
                if pend[m] != acc:
                    pend[m] = acc
                    changed = True
            if not changed:
                break
        for m in ctx:
            ctx[m] = pend[m] if pend[m] is not None else frozenset()
        return ctx


# --------------------------------------------------------------------------- #
# rule evaluation
# --------------------------------------------------------------------------- #

def _effective(acc: Access, ctx: Dict[str, frozenset]) -> frozenset:
    return acc.locks | ctx.get(acc.method, frozenset())


def _lint_class(cls: _ClassInfo, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    entries = cls.entries()
    has_threads = bool(entries)
    if not has_threads and not cls.lock_attrs:
        return findings
    ctx = cls.context_locks()
    thread_side = cls.closure(entries)
    caller_roots = {m for m, rec in cls.methods.items()
                    if rec.is_public and m != "__init__"}
    caller_side = cls.closure(caller_roots)

    # __init__ is publish-before-start, but a nested def inside it that
    # is a thread TARGET (the spawn-in-constructor idiom) runs after
    # start and races like any other entrypoint — only non-thread-side
    # __init__ locals stay excluded as init-time helpers. Every rule
    # shares this exemption (a THR003 on __init__ itself would flag code
    # that provably runs before any thread exists).
    def _init_time(m: str) -> bool:
        return m == "__init__" or (m.startswith("__init__.")
                                   and m not in thread_side)

    per_attr: Dict[str, List[Access]] = {}
    for m, rec in cls.methods.items():
        if _init_time(m):
            continue
        for a in rec.accesses:
            per_attr.setdefault(a.attr, []).append(a)

    # check-then-act attrs get the more specific THR003 diagnosis; the
    # generic shared-mutation rules skip them
    cta_attrs: Set[str] = set()
    for m, rec in cls.methods.items():
        if _init_time(m):
            continue
        for _line, locks, _reads, mut_attrs in rec.check_then_act:
            if not (locks | ctx.get(m, frozenset())):
                cta_attrs |= mut_attrs

    def _is_shared(attr: str, accs: List[Access]) -> bool:
        """Cross-thread visibility: accessed from both sides, OR public
        (readable cross-object, the way server.py reads the batcher's
        counters) and written thread-side, OR mutated from both sides.
        THR003 gates on the SAME predicate — a check-then-act deferred
        out of the generic rules must not fall below its bar."""
        t_acc = [a for a in accs if a.method in thread_side]
        muts = [a for a in accs if a.kind != READ]
        return (bool(t_acc)
                and any(a.method in caller_side for a in accs)) or \
            (attr in cls.public_attrs and
             any(a.kind != READ for a in t_acc)) or \
            (any(a.method in thread_side for a in muts) and
             any(a.method in caller_side for a in muts))

    for attr, accs in sorted(per_attr.items()):
        muts = [a for a in accs if a.kind != READ]
        if not muts:
            continue
        shared = _is_shared(attr, accs)
        # THR006 first: mixed discipline needs no thread-side evidence
        locked_muts = [a for a in muts if _effective(a, ctx)]
        unlocked_muts = [a for a in muts if not _effective(a, ctx)]
        if cls.lock_attrs and locked_muts and unlocked_muts:
            a = unlocked_muts[0]
            findings.append(Finding(
                rule="THR006", path=rel, line=a.line,
                symbol=f"{cls.name}.{a.method}", key=attr,
                message=f"self.{attr} is mutated under "
                        f"{sorted(_effective(locked_muts[0], ctx))} at "
                        f"line {locked_muts[0].line} but without any lock "
                        f"here — one discipline is wrong"))
            continue
        if not (has_threads and shared):
            continue
        common = None
        for a in accs:
            eff = _effective(a, ctx)
            common = eff if common is None else (common & eff)
        if common:
            continue                        # one lock protects every access
        if not unlocked_muts:
            # every mutation holds SOME lock — but two writers under
            # DISJOINT locks still don't exclude each other
            mut_lock_sets = {frozenset(_effective(a, ctx)) for a in muts}
            if not frozenset.intersection(*mut_lock_sets):
                a = muts[0]
                desc = " vs ".join(
                    "+".join(sorted(s))
                    for s in sorted(mut_lock_sets, key=sorted))
                findings.append(Finding(
                    rule="THR006", path=rel, line=a.line,
                    symbol=f"{cls.name}.{a.method}", key=attr,
                    message=f"self.{attr} is mutated under DIFFERENT "
                            f"locks ({desc}) — writers under disjoint "
                            f"locks do not exclude each other"))
            continue                        # only torn reads — below the bar
        if attr in cta_attrs and has_threads:
            continue                        # THR003 reports this one
        a = unlocked_muts[0]
        rule = "THR004" if a.kind == AUGWRITE else "THR001"
        what = ("non-atomic increment of" if a.kind == AUGWRITE
                else "unsynchronized mutation of")
        other = "thread" if a.method in thread_side else "caller"
        findings.append(Finding(
            rule=rule, path=rel, line=a.line,
            symbol=f"{cls.name}.{a.method}", key=attr,
            message=f"{what} self.{attr} with no lock held, but the "
                    f"attribute is shared across threads "
                    f"({other}-side write; no common lock over its "
                    f"{len(accs)} accesses)"))

    # THR003 check-then-act
    if has_threads:
        for m, rec in cls.methods.items():
            if _init_time(m):
                continue
            for line, locks, _reads, mut_attrs in rec.check_then_act:
                if locks | ctx.get(m, frozenset()):
                    continue
                for attr in sorted(mut_attrs):
                    if not _is_shared(attr, per_attr.get(attr, [])):
                        continue
                    findings.append(Finding(
                        rule="THR003", path=rel, line=line,
                        symbol=f"{cls.name}.{m}", key=attr,
                        message=f"check-then-act on shared self.{attr} "
                                f"outside any lock (test reads it, body "
                                f"mutates it; another thread can "
                                f"interleave)"))

    # THR002 lock-order cycles + self-deadlock
    edges: Dict[str, Set[str]] = {}
    for m, rec in cls.methods.items():
        base = ctx.get(m, frozenset())
        for lock, held, line in rec.acquires:
            for h in (held | base):
                if h == lock:
                    if lock not in cls.reentrant_locks:
                        findings.append(Finding(
                            rule="THR002", path=rel, line=line,
                            symbol=f"{cls.name}.{m}", key=f"self:{lock}",
                            message=f"self.{lock} acquired while already "
                                    f"held — a plain threading.Lock is "
                                    f"not re-entrant and deadlocks here"))
                else:
                    edges.setdefault(h, set()).add(lock)
        # call edges: callee's own locks acquired under the caller's held
        for callee, held, line in rec.calls:
            crec = cls.methods.get(callee)
            if crec is None:
                continue
            for h in (held | base):
                for lock in crec.own_locks:
                    if h != lock:
                        edges.setdefault(h, set()).add(lock)
    seen_cycles: Set[Tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: List[str]) -> None:
        for nxt in sorted(edges.get(node, ())):
            if nxt == start:
                cyc = tuple(sorted(path))
                if cyc not in seen_cycles:
                    seen_cycles.add(cyc)
                    findings.append(Finding(
                        rule="THR002", path=rel, line=cls.node.lineno,
                        symbol=cls.name, key="->".join(cyc),
                        message=f"lock-order cycle: "
                                f"{' -> '.join(path + [start])} — two "
                                f"threads taking these in opposite order "
                                f"deadlock"))
            elif nxt not in path:
                dfs(start, nxt, path + [nxt])

    for lock in sorted(edges):
        dfs(lock, lock, [lock])

    # THR005 CUDA from a thread entrypoint's call graph
    if rel not in SANCTIONED_CUDA_THREAD_MODULES:
        for m in sorted(thread_side):
            rec = cls.methods[m]
            if rec.uses_cuda:
                findings.append(Finding(
                    rule="THR005", path=rel, line=rec.uses_cuda[0],
                    symbol=f"{cls.name}.{m}", key="cuda",
                    message="CUDA touched from a thread entrypoint "
                            "outside the sanctioned modules — off-main-"
                            "thread CUDA work races the train thread's "
                            "streams"))
    return findings


def _torch_aliases(tree: ast.Module) -> Dict[str, bool]:
    """{name: whether it IS the CUDA module} for names bound to torch
    (``torch``, ``torch.cuda``, ``from torch import cuda``)."""
    out: Dict[str, bool] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    if a.asname:
                        out[a.asname] = a.name == "torch.cuda"
                    else:
                        out.setdefault("torch", False)
        elif isinstance(n, ast.ImportFrom) and n.module and \
                (n.module == "torch" or n.module.startswith("torch.")):
            for a in n.names:
                if n.module.startswith("torch.cuda") or a.name == "cuda":
                    out[a.asname or a.name] = True
    return out


def lint_file(path: str, source: Optional[str] = None,
              tree: Optional[ast.Module] = None) -> List[Finding]:
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    if tree is None:                 # run_lints hands in a shared parse
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            return [Finding(rule="THR000", path=relpath(path),
                            line=e.lineno or 1, symbol="<module>",
                            message=f"syntax error: {e.msg}",
                            key="syntax")]
    rel = relpath(path)
    aliases = _torch_aliases(tree)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            try:
                findings.extend(_lint_class(_ClassInfo(node, rel, aliases),
                                            rel))
            except RecursionError:
                pass
    return findings
