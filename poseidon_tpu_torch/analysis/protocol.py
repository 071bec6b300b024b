"""Wire-schema lint (PROTO2xx): the distributed protocol, statically checked
(the port's ``poseidon_tpu/analysis/protocol.py``, over the port's
``ParamService._serve``, ``InferenceServer._dispatch``, their senders and
``proto/wire.py``).

The async-SSP tier and the serving front door speak a hand-rolled RPC
vocabulary: pickled dicts with a ``"kind"`` discriminator, dispatched by
``kind ==`` chains (``ParamService._serve``,
``InferenceServer._dispatch``) and produced by client call sites
(``_rpc``/``_push_rpc``/``_pull_rpc``/``send_frame`` dict literals).
Nothing type-checks that vocabulary: a sender can invent a kind no
dispatcher handles, a handler can read a field some sender omits, a
client can read a reply key the handler never produces — and every one of
those is a runtime hang or a dropped connection in a distributed chaos
test instead of a diff-time finding. This module AST-extracts the whole
message vocabulary from both sides of each service and cross-checks it:

- PROTO201 — kind sent by a client but handled by no dispatcher branch.
- PROTO202 — kind handled by a dispatcher but sent by no known sender
  (dead vocabulary, or a sender that silently fell out of the scan).
- PROTO203 — field a handler requires (plain ``msg["f"]`` read, no
  default) that some sender of that kind omits.
- PROTO204 — reply key a client reads (plain subscript, unguarded) that
  the handler for that kind never produces.
- PROTO205 — unpickle-before-auth: a connection-serving method that
  parses frames (pickles!) before the auth handshake, or a frame-parsing
  endpoint with no handshake at all.
- PROTO206 — a non-idempotent (state-accumulating) kind whose sender
  omits the seq/clock the service's exactly-once dedup keys on.
- PROTO207 — framing: a wire length prefix that reaches the payload
  recv unchecked, or checked only against an absurd (>= 2**31) literal
  cap — the multi-petabyte-allocation-from-a-garbage-header hole.

The extraction is also EMITTED as a machine-readable protocol schema
(``analysis/protocol_schema.json`` in this package) that later changes
diff against exactly like the step contract goldens: adding/removing a
kind, a field, or a reply key is a reviewed ``--refresh-schema``
decision, never an accident. The port's clients and the JAX package's
serve each other, so the port's schema must also equal the JAX package's
``evidence/protocol_schema.json`` kind for kind and field for field
(file paths aside); the tests hold the two against each other.
Line numbers are deliberately excluded from the schema (like finding
fingerprints) so it survives unrelated edits.

Scope and honesty: the pass is lexical and per-service. It follows ONE
hop of ``self._method(msg)`` delegation, resolves ``**view`` /
``**self._member_view()`` reply splats through same-class return
literals, and treats a subscript read guarded by an ``"k" in x`` test as
optional. Senders outside the configured files (external ops tooling)
are declared per-service instead of scanned. What it cannot resolve it
marks ``open`` and stays quiet about, rather than guessing.

Findings ride the shared machinery: ``Finding`` fingerprints,
``baseline.json`` grandfathering with written reasons, and in-place
``# static-ok: PROTO2xx`` pragmas. Everything is pure ``ast`` — it
imports nothing it lints, fast enough for a pre-commit hook.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import Finding, REPO_ROOT, pragma_suppressed, relpath

__all__ = [
    "ServiceSpec", "SERVICES", "SCHEMA_PATH", "extract_service",
    "extract_schema", "lint_framing", "run_protocol_lint", "diff_schema",
    "load_schema", "save_schema",
]

SCHEMA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "protocol_schema.json")

# call names that put a kind-keyed dict on the wire (client side)
SENDER_CALLS = ("_rpc", "_push_rpc", "_pull_rpc", "_send_msg", "send_frame")
# call names that parse a frame off the wire (server side)
RECV_CALLS = ("recv_frame", "recv_frame_sized", "_recv_msg",
              "_recv_msg_sized")
AUTH_CALLS = ("server_handshake",)


@dataclass(frozen=True)
class ServiceSpec:
    """One socket service: where its dispatcher lives, where its senders
    live, and which kinds are legitimately produced by tooling outside
    the scanned files (ops surface)."""

    name: str
    dispatcher: Tuple[str, str, str]      # (relpath, Class, method)
    recv_method: str                      # the method that parses frames
    sender_files: Tuple[str, ...]
    external_kinds: Tuple[str, ...] = ()


SERVICES: Tuple[ServiceSpec, ...] = (
    ServiceSpec(
        name="param_service",
        dispatcher=("poseidon_tpu_torch/parallel/async_ssp.py",
                    "ParamService", "_serve"),
        recv_method="_serve",
        sender_files=("poseidon_tpu_torch/parallel/async_ssp.py",),
    ),
    ServiceSpec(
        name="inference",
        dispatcher=("poseidon_tpu_torch/serving/server.py",
                    "InferenceServer", "_dispatch"),
        recv_method="_serve_conn",
        sender_files=("poseidon_tpu_torch/serving/client.py",),
    ),
)

# the framing modules PROTO207 audits (length prefix -> bounded recv)
FRAMING_TARGETS = ("poseidon_tpu_torch/proto/wire.py",)

# how many hops of ``return self._m(..., msg, ...)`` a dispatcher branch
# is followed through
DELEGATION_DEPTH = 3

# an "absurd" literal frame cap: at or beyond this, a garbage header
# still buys a multi-gigabyte allocation attempt before failing
ABSURD_CAP = 1 << 31


# --------------------------------------------------------------------------- #
# small AST helpers
# --------------------------------------------------------------------------- #

def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _is_self_call(node: ast.Call) -> bool:
    return (isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self")


def _const_str(node) -> Optional[str]:
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


def _find_class(tree: ast.Module, name: str) -> Optional[ast.ClassDef]:
    for n in tree.body:
        if isinstance(n, ast.ClassDef) and n.name == name:
            return n
    return None


def _methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _int_value(node, consts: Dict[str, int]) -> Optional[int]:
    """Evaluate a constant-ish int expression (literal, module constant,
    shifts/arithmetic of those) — enough to judge a frame-cap literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.BinOp):
        a = _int_value(node.left, consts)
        b = _int_value(node.right, consts)
        if a is None or b is None:
            return None
        try:
            if isinstance(node.op, ast.LShift):
                return a << b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Pow):
                return a ** b
            if isinstance(node.op, ast.Sub):
                return a - b
        except Exception:  # noqa: BLE001 — absurd exponents etc.
            return None
    return None


def _module_int_consts(tree: ast.Module) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for n in tree.body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                isinstance(n.targets[0], ast.Name):
            v = _int_value(n.value, out)
            if v is not None:
                out[n.targets[0].id] = v
    return out


# --------------------------------------------------------------------------- #
# message-shape extraction
# --------------------------------------------------------------------------- #

@dataclass
class MsgShape:
    """What one side knows about a kind's message: required keys (plain
    subscript reads / literal dict keys), optional keys (``.get`` reads,
    conditional stores), and whether the set is closed (every dict splat
    resolved)."""

    required: Set[str] = field(default_factory=set)
    optional: Set[str] = field(default_factory=set)
    open: bool = False

    def all_keys(self) -> Set[str]:
        return self.required | self.optional


def _reads_of(body: Sequence[ast.stmt], var: str) -> MsgShape:
    """Fields read off dict ``var`` inside ``body``: ``var["f"]`` is a
    required read unless the surrounding function also membership-tests
    ``"f" in var``; ``var.get("f", ...)`` is optional."""
    shape = MsgShape()
    guarded: Set[str] = set()
    for stmt in body:
        for n in ast.walk(stmt):
            # "f" in var  (any polarity / position) — guard, not a read
            if isinstance(n, ast.Compare) and len(n.ops) == 1 and \
                    isinstance(n.ops[0], (ast.In, ast.NotIn)) and \
                    isinstance(n.comparators[0], ast.Name) and \
                    n.comparators[0].id == var:
                k = _const_str(n.left)
                if k is not None:
                    guarded.add(k)
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Subscript) and \
                    isinstance(n.value, ast.Name) and n.value.id == var \
                    and isinstance(n.ctx, ast.Load):
                k = _const_str(n.slice)
                if k is not None:
                    shape.required.add(k)
            elif isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "get" and \
                    isinstance(n.func.value, ast.Name) and \
                    n.func.value.id == var and n.args:
                k = _const_str(n.args[0])
                if k is not None:
                    shape.optional.add(k)
    shape.optional |= shape.required & guarded
    shape.required -= guarded
    return shape


def _splat_keys(methods: Dict[str, ast.FunctionDef],
                fn: ast.FunctionDef, value: ast.expr) -> Optional[Set[str]]:
    """Resolve a ``**value`` splat (or a bare dict-valued expression) to
    its literal keys: a direct ``self._m()`` call, or a Name every one of
    whose assignments in ``fn`` is such a call, resolved through the
    method's return dict literal. None = unresolvable (schema goes open).
    """
    call = None
    if isinstance(value, ast.Call) and _is_self_call(value):
        call = value
    elif isinstance(value, ast.Name):
        calls = []
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == value.id
                    for t in n.targets):
                calls.append(n.value)
        if calls and all(isinstance(c, ast.Call) and _is_self_call(c)
                         and c.func.attr == calls[0].func.attr  # type: ignore[attr-defined]
                         for c in calls):
            call = calls[0]
    if call is None:
        return None
    target = methods.get(call.func.attr)  # type: ignore[attr-defined]
    if target is None:
        return None
    keys: Set[str] = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict):
            for k in n.value.keys:
                ks = _const_str(k) if k is not None else None
                if k is None or ks is None:
                    return None
                keys.add(ks)
    return keys or None


def _dict_keys(methods: Dict[str, ast.FunctionDef], fn: ast.FunctionDef,
               d: ast.Dict) -> Tuple[Set[str], bool]:
    """(keys, open) for a reply dict literal, resolving ``**`` splats."""
    keys: Set[str] = set()
    open_ = False
    for k, v in zip(d.keys, d.values):
        if k is None:                      # **splat
            got = _splat_keys(methods, fn, v)
            if got is None:
                open_ = True
            else:
                keys |= got
        else:
            ks = _const_str(k)
            if ks is None:
                open_ = True
            else:
                keys.add(ks)
    return keys, open_


def _reply_shapes(methods: Dict[str, ast.FunctionDef],
                  fn: ast.FunctionDef, body: Sequence[ast.stmt],
                  msg_var: str) -> Tuple[MsgShape, List[str]]:
    """Replies produced by one dispatcher branch: dict literals passed to
    send calls, dicts returned (the serving shape, where the caller
    sends the return value), and ``return self._handler(..., msg, ...)``
    delegation. Returns (reply shape, [(delegated method, msg's argument
    position)])."""
    shape = MsgShape()
    delegated: List[Tuple[str, int]] = []

    def absorb_dict(d: ast.Dict) -> None:
        keys, open_ = _dict_keys(methods, fn, d)
        shape.required |= keys
        shape.open = shape.open or open_

    def absorb_name(name: str) -> None:
        # a reply assembled as  reply = {...}; reply["k"] = v; return reply
        lits = [n.value for n in ast.walk(fn)
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in n.targets)]
        if not lits:
            # e.g. _send_msg(conn, view) where view = self._member_view()
            got = _splat_keys(methods, fn, ast.Name(id=name, ctx=ast.Load()))
            if got is None:
                shape.open = True
            else:
                shape.required |= got
            return
        for d in lits:
            absorb_dict(d)
        for n in ast.walk(fn):
            if isinstance(n, ast.Subscript) and \
                    isinstance(n.value, ast.Name) and n.value.id == name \
                    and isinstance(n.ctx, ast.Store):
                k = _const_str(n.slice)
                if k is not None:
                    shape.optional.add(k)
                else:
                    shape.open = True

    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call) and _call_name(n) in SENDER_CALLS:
                for a in n.args:
                    if isinstance(a, ast.Dict):
                        absorb_dict(a)
                    elif isinstance(a, ast.Name) and a.id not in (
                            "conn", "sock", "sk", "self"):
                        absorb_name(a.id)
            elif isinstance(n, ast.Return) and n.value is not None:
                if isinstance(n.value, ast.Dict):
                    absorb_dict(n.value)
                elif isinstance(n.value, ast.Call) and \
                        _is_self_call(n.value) and any(
                            isinstance(a, ast.Name) and a.id == msg_var
                            for a in n.value.args):
                    pos = next(i for i, a in enumerate(n.value.args)
                               if isinstance(a, ast.Name)
                               and a.id == msg_var)
                    delegated.append(
                        (n.value.func.attr, pos))  # type: ignore[attr-defined]
                elif isinstance(n.value, ast.Name):
                    absorb_name(n.value.id)
                elif isinstance(n.value, ast.Constant) and \
                        n.value.value is None:
                    pass                   # "bye": close, no reply
                else:
                    shape.open = True
    return shape, delegated


def _branch_mutates(methods: Dict[str, ast.FunctionDef],
                    body: Sequence[ast.stmt]) -> bool:
    """Non-idempotent detection: the branch (or a one-hop self method it
    calls) ACCUMULATES state — a keyed augmented assignment onto ``self``
    state (``self.table[k] += v``), or a call to an additive/apply helper
    (plain-name ``*add*`` functions like ``_tree_add_any``, or ``self``
    methods named ``*apply*`` like ``_apply_adarevision``). Idempotent
    membership changes (``.add``/``.discard`` on sets, admit/retire/done)
    and plain telemetry counters (``self.n += 1``) deliberately do not
    count: replaying those is harmless, so they need no seq."""
    def scan(stmts, depth) -> bool:
        for stmt in stmts:
            for n in ast.walk(stmt):
                if isinstance(n, ast.AugAssign) and \
                        isinstance(n.target, ast.Subscript):
                    root = n.target.value
                    while isinstance(root, (ast.Subscript, ast.Attribute)):
                        root = root.value
                    if isinstance(root, ast.Name) and root.id == "self":
                        return True
                if isinstance(n, ast.Call):
                    name = _call_name(n)
                    if isinstance(n.func, ast.Name) and name and \
                            "add" in name:
                        return True
                    if _is_self_call(n) and name and "apply" in name:
                        return True
                    if depth > 0 and _is_self_call(n) and \
                            n.func.attr in methods:  # type: ignore[attr-defined]
                        if scan(methods[n.func.attr].body,  # type: ignore[attr-defined]
                                depth - 1):
                            return True
        return False
    return scan(body, 1)


# --------------------------------------------------------------------------- #
# dispatcher side
# --------------------------------------------------------------------------- #

def _kind_of_test(test: ast.expr, kind_vars: Set[str],
                  msg_var: str) -> Optional[str]:
    """``kind == "push"`` / ``msg["kind"] == "push"`` -> "push"."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)):
        return None
    left, right = test.left, test.comparators[0]
    k = _const_str(right)
    if k is None:
        k, left = _const_str(left), right
    if k is None:
        return None
    if isinstance(left, ast.Name) and left.id in kind_vars:
        return k
    if isinstance(left, ast.Subscript) and \
            isinstance(left.value, ast.Name) and left.value.id == msg_var \
            and _const_str(left.slice) == "kind":
        return k
    return None


@dataclass
class HandlerInfo:
    kind: str
    line: int
    fields: MsgShape
    reply: MsgShape
    mutating: bool
    symbol: str


def _extract_dispatcher(tree: ast.Module, cls_name: str,
                        method: str) -> Dict[str, HandlerInfo]:
    cls = _find_class(tree, cls_name)
    if cls is None:
        return {}
    methods = _methods(cls)
    fn = methods.get(method)
    if fn is None:
        return {}
    args = [a.arg for a in fn.args.args if a.arg != "self"]
    # the message variable: a ``msg`` parameter (the _dispatch shape), a
    # local assigned from a frame recv (the _serve connection-loop
    # shape), or the last parameter as a fallback
    recv_locals = [n.targets[0].id for n in ast.walk(fn)
                   if isinstance(n, ast.Assign) and len(n.targets) == 1
                   and isinstance(n.targets[0], ast.Name)
                   and isinstance(n.value, ast.Call)
                   and _call_name(n.value) in RECV_CALLS]
    if "msg" in args:
        msg_var = "msg"
    elif recv_locals:
        msg_var = recv_locals[0]
    else:
        msg_var = args[-1] if args else "msg"
    kind_vars = {n.targets[0].id for n in ast.walk(fn)
                 if isinstance(n, ast.Assign) and len(n.targets) == 1
                 and isinstance(n.targets[0], ast.Name)
                 and isinstance(n.value, ast.Subscript)
                 and isinstance(n.value.value, ast.Name)
                 and n.value.value.id == msg_var
                 and _const_str(n.value.slice) == "kind"}
    out: Dict[str, HandlerInfo] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        kind = _kind_of_test(node.test, kind_vars, msg_var)
        if kind is None or kind in out:
            continue
        fields = _reads_of(node.body, msg_var)
        reply, delegated = _reply_shapes(methods, fn, node.body, msg_var)
        mutating = _branch_mutates(methods, node.body)
        # delegation is followed through up to DELEGATION_DEPTH hops (a
        # handler that hands msg on to a shared submit path)
        work = [(d, 1) for d in delegated]
        seen: Set[str] = set()
        while work:
            (dname, pos), depth = work.pop(0)
            dfn = methods.get(dname)
            if dfn is None or depth > DELEGATION_DEPTH:
                reply.open = True
                continue
            if dname in seen:
                continue
            seen.add(dname)
            dargs = [a.arg for a in dfn.args.args if a.arg != "self"]
            dmsg = dargs[pos] if pos < len(dargs) else msg_var
            dshape = _reads_of(dfn.body, dmsg)
            fields.required |= dshape.required
            fields.optional |= dshape.optional
            dreply, deeper = _reply_shapes(methods, dfn, dfn.body, dmsg)
            reply.required |= dreply.required
            reply.optional |= dreply.optional
            reply.open = reply.open or dreply.open
            mutating = mutating or _branch_mutates(methods, dfn.body)
            work.extend((d, depth + 1) for d in deeper)
        fields.required.discard("kind")
        fields.optional.discard("kind")
        out[kind] = HandlerInfo(kind=kind, line=node.lineno, fields=fields,
                                reply=reply, mutating=mutating,
                                symbol=f"{cls_name}.{method}")
    return out


# --------------------------------------------------------------------------- #
# sender side
# --------------------------------------------------------------------------- #

@dataclass
class SenderSite:
    kind: str
    path: str                      # repo-relative
    line: int
    symbol: str                    # qualname of the enclosing function
    fields: MsgShape               # keys the sender puts in the message
    reply_reads: MsgShape          # keys it reads off the reply


def _function_units(tree: ast.Module):
    """Yield (qualname, fn, class_methods) for every function/method."""
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n.name, n, {}
        elif isinstance(n, ast.ClassDef):
            meths = _methods(n)
            for name, fn in meths.items():
                yield f"{n.name}.{name}", fn, meths


def _literal_dicts(fn: ast.FunctionDef) -> Dict[str, Tuple[MsgShape, int]]:
    """Name -> (shape, line) for dicts built as literals (+ later
    subscript stores, recorded optional) in this function."""
    out: Dict[str, Tuple[MsgShape, int]] = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict) and \
                len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
            out[n.targets[0].id] = (_dict_literal_shape(n.value), n.lineno)
        elif isinstance(n, ast.AnnAssign) and isinstance(n.value, ast.Dict) \
                and isinstance(n.target, ast.Name):
            out[n.target.id] = (_dict_literal_shape(n.value), n.lineno)
    for n in ast.walk(fn):
        if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name) \
                and n.value.id in out and isinstance(n.ctx, ast.Store):
            k = _const_str(n.slice)
            if k is not None:
                out[n.value.id][0].optional.add(k)
            else:
                out[n.value.id][0].open = True
    return out


def _dict_literal_shape(d: ast.Dict) -> MsgShape:
    shape = MsgShape()
    for k in d.keys:
        ks = _const_str(k) if k is not None else None
        if ks is None:
            shape.open = True
        else:
            shape.required.add(ks)
    return shape


def _reply_reads_for(fn: ast.FunctionDef, call: ast.Call,
                     methods: Dict[str, ast.FunctionDef]) -> MsgShape:
    """Reply keys read after ``var = self._rpc({...})``: subscripts and
    ``.get`` on the assigned name, plus ONE hop into ``self._m(var)``; or,
    for ``self._m(self._rpc({...}))``, the reads of ``_m``'s parameter."""
    target: Optional[str] = None
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and n.value is call and \
                len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
            target = n.targets[0].id
        elif isinstance(n, ast.Call) and _is_self_call(n) and any(
                a is call for a in n.args):
            hop = methods.get(n.func.attr)  # type: ignore[attr-defined]
            hargs = ([a.arg for a in hop.args.args if a.arg != "self"]
                     if hop is not None else [])
            pos = next(i for i, a in enumerate(n.args) if a is call)
            if pos < len(hargs):
                return _reads_of(hop.body, hargs[pos])
    if target is None:
        return MsgShape()
    shape = _reads_of(fn.body, target)
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and _is_self_call(n) and any(
                isinstance(a, ast.Name) and a.id == target
                for a in n.args):
            hop = methods.get(n.func.attr)  # type: ignore[attr-defined]
            if hop is None:
                continue
            hargs = [a.arg for a in hop.args.args if a.arg != "self"]
            if not hargs:
                continue
            pos = next(i for i, a in enumerate(n.args)
                       if isinstance(a, ast.Name) and a.id == target)
            if pos >= len(hargs):
                continue
            hshape = _reads_of(hop.body, hargs[pos])
            shape.required |= hshape.required
            shape.optional |= hshape.optional
    return shape


def _extract_senders(tree: ast.Module, rel: str) -> List[SenderSite]:
    sites: List[SenderSite] = []
    for qual, fn, methods in _function_units(tree):
        local = _literal_dicts(fn)
        for n in ast.walk(fn):
            if not (isinstance(n, ast.Call)
                    and _call_name(n) in SENDER_CALLS):
                continue
            shape: Optional[MsgShape] = None
            line = n.lineno
            for a in n.args:
                if isinstance(a, ast.Dict):
                    cand = _dict_literal_shape(a)
                    if "kind" in cand.required:
                        shape = cand
                elif isinstance(a, ast.Name) and a.id in local:
                    cand = local[a.id][0]
                    if "kind" in cand.required:
                        shape = cand
            if shape is None:
                continue
            # the kind value: re-find it in whichever dict matched
            kind = None
            for a in n.args:
                d = a if isinstance(a, ast.Dict) else None
                if d is None and isinstance(a, ast.Name) and a.id in local:
                    for m in ast.walk(fn):
                        if isinstance(m, ast.Assign) and \
                                isinstance(m.value, ast.Dict) and any(
                                    isinstance(t, ast.Name) and t.id == a.id
                                    for t in m.targets):
                            d = m.value
                        elif isinstance(m, ast.AnnAssign) and \
                                isinstance(m.value, ast.Dict) and \
                                isinstance(m.target, ast.Name) and \
                                m.target.id == a.id:
                            d = m.value
                if d is None:
                    continue
                for k, v in zip(d.keys, d.values):
                    if k is not None and _const_str(k) == "kind":
                        kind = _const_str(v)
                if kind is not None:
                    break
            if kind is None:
                continue               # dynamic kind: out of lexical scope
            fields = MsgShape(required=set(shape.required) - {"kind"},
                              optional=set(shape.optional) - {"kind"},
                              open=shape.open)
            sites.append(SenderSite(
                kind=kind, path=rel, line=line, symbol=qual, fields=fields,
                reply_reads=_reply_reads_for(fn, n, methods)))
    return sites


# --------------------------------------------------------------------------- #
# PROTO205: auth-before-unpickle
# --------------------------------------------------------------------------- #

def _auth_findings(tree: ast.Module, rel: str, cls_name: str,
                   recv_method: str) -> List[Finding]:
    cls = _find_class(tree, cls_name)
    if cls is None:
        return []
    fn = _methods(cls).get(recv_method)
    if fn is None:
        return []
    recv_lines = [n.lineno for n in ast.walk(fn)
                  if isinstance(n, ast.Call) and _call_name(n) in RECV_CALLS]
    if not recv_lines:
        return []
    auth_lines = [n.lineno for n in ast.walk(cls)
                  if isinstance(n, ast.Call) and _call_name(n) in AUTH_CALLS]
    sym = f"{cls_name}.{recv_method}"
    if not auth_lines:
        return [Finding(
            rule="PROTO205", path=rel, line=min(recv_lines), symbol=sym,
            key="no-auth",
            message="frame-parsing endpoint (pickle loads!) with no "
                    "connection handshake anywhere in the class — anyone "
                    "who can reach the port gets code execution")]
    if min(auth_lines) > min(recv_lines):
        return [Finding(
            rule="PROTO205", path=rel, line=min(recv_lines), symbol=sym,
            key="unpickle-before-auth",
            message=f"first frame parse (line {min(recv_lines)}) precedes "
                    f"the auth handshake (line {min(auth_lines)}): "
                    f"unauthenticated bytes reach the pickle loader")]
    return []


# --------------------------------------------------------------------------- #
# PROTO207: framing length-prefix audit
# --------------------------------------------------------------------------- #

def lint_framing(path: str, source: Optional[str] = None,
                 tree: Optional[ast.Module] = None) -> List[Finding]:
    """Audit a framing module: every wire-decoded length that flows into
    the payload recv must first be bounds-checked, and a literal cap must
    be sane (< 2**31). A configurable cap (function call / attribute
    read) passes — configurability is the fix, not the hole."""
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    if tree is None:
        tree = ast.parse(source)
    rel = relpath(path)
    consts = _module_int_consts(tree)
    findings: List[Finding] = []
    for qual, fn, _ in _function_units(tree):
        # length names: (n,) = struct.unpack(...) / n = struct.unpack(...)[0]
        length_names: Set[str] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                val = n.value
                unpacked = (isinstance(val, ast.Call)
                            and _call_name(val) == "unpack")
                if isinstance(val, ast.Subscript):
                    unpacked = (isinstance(val.value, ast.Call)
                                and _call_name(val.value) == "unpack")
                if not unpacked:
                    continue
                t = n.targets[0]
                if isinstance(t, (ast.Tuple, ast.List)):
                    for e in t.elts:
                        if isinstance(e, ast.Name):
                            length_names.add(e.id)
                elif isinstance(t, ast.Name):
                    length_names.add(t.id)
        if not length_names:
            continue
        recvs = [n for n in ast.walk(fn)
                 if isinstance(n, ast.Call)
                 and _call_name(n) in ("recv_exact", "recv")
                 and any(isinstance(a, ast.Name) and a.id in length_names
                         for a in n.args)]
        if not recvs:
            continue
        # function-local constant assignments overlay the module ones
        # (``cap = 1 << 32`` inside the recv function is just as absurd)
        local_consts = dict(consts)
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                v = _int_value(n.value, local_consts)
                if v is not None:
                    local_consts[n.targets[0].id] = v
        caps: List[Tuple[int, Optional[int]]] = []   # (line, literal or None)
        for n in ast.walk(fn):
            if isinstance(n, ast.Compare) and len(n.ops) == 1 and \
                    isinstance(n.ops[0], (ast.Gt, ast.GtE, ast.Lt,
                                          ast.LtE)):
                sides = (n.left, n.comparators[0])
                if any(isinstance(s, ast.Name) and s.id in length_names
                       for s in sides):
                    other = sides[1] if (isinstance(sides[0], ast.Name)
                                         and sides[0].id in length_names) \
                        else sides[0]
                    caps.append((n.lineno,
                                 _int_value(other, local_consts)))
        first_recv = min(r.lineno for r in recvs)
        pre = [c for c in caps if c[0] <= first_recv]
        if not pre:
            findings.append(Finding(
                rule="PROTO207", path=rel, line=first_recv, symbol=qual,
                key="unchecked-length",
                message="wire-decoded length prefix reaches the payload "
                        "recv with no bounds check — a garbage header is "
                        "an attempted multi-petabyte allocation"))
            continue
        for line, cap in pre:
            if cap is not None and cap >= ABSURD_CAP:
                findings.append(Finding(
                    rule="PROTO207", path=rel, line=line, symbol=qual,
                    key="absurd-cap",
                    message=f"frame cap {cap} (>= {ABSURD_CAP}) still "
                            f"admits multi-gigabyte allocations from a "
                            f"garbage header; use a configurable sane "
                            f"cap (see wire.max_frame_bytes)"))
    return findings


# --------------------------------------------------------------------------- #
# cross-check + schema
# --------------------------------------------------------------------------- #

def _pragma_filter(findings: List[Finding]) -> List[Finding]:
    """Apply the shared in-place ``# static-ok: RULE`` suppression (same
    grammar as the THR/JIT lints), loading each finding's file once."""
    kept: List[Finding] = []
    cache: Dict[str, List[str]] = {}
    for f in findings:
        path = f.path if os.path.isabs(f.path) \
            else os.path.join(REPO_ROOT, f.path)
        if f.path not in cache:
            try:
                with open(path, encoding="utf-8") as fh:
                    cache[f.path] = fh.read().splitlines()
            except OSError:
                cache[f.path] = []
        if not pragma_suppressed(cache[f.path], f):
            kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.key))
    return kept


def extract_service(spec: ServiceSpec,
                    root: str = REPO_ROOT) -> Tuple[Dict, List[Finding]]:
    """Extract one service's schema and cross-check findings
    (pragma-filtered)."""
    findings: List[Finding] = []

    def load(rel: str) -> Optional[ast.Module]:
        path = rel if os.path.isabs(rel) else os.path.join(root, rel)
        try:
            with open(path, encoding="utf-8") as f:
                return ast.parse(f.read())
        except (OSError, SyntaxError):
            findings.append(Finding(
                rule="PROTO200", path=relpath(path), line=1,
                symbol="<config>", key="unreadable",
                message=f"configured protocol file missing or "
                        f"unparseable: {rel}"))
            return None

    drel, cls_name, method = spec.dispatcher
    dtree = load(drel)
    handlers = (_extract_dispatcher(dtree, cls_name, method)
                if dtree is not None else {})
    if dtree is not None:
        findings.extend(_auth_findings(dtree, relpath(
            drel if os.path.isabs(drel) else os.path.join(root, drel)),
            cls_name, spec.recv_method))
    senders: List[SenderSite] = []
    for srel in spec.sender_files:
        stree = dtree if srel == drel else load(srel)
        if stree is None:
            continue
        sp = srel if os.path.isabs(srel) else os.path.join(root, srel)
        senders.extend(_extract_senders(stree, relpath(sp)))
    drel_rep = relpath(drel if os.path.isabs(drel)
                       else os.path.join(root, drel))

    by_kind: Dict[str, List[SenderSite]] = {}
    for s in senders:
        by_kind.setdefault(s.kind, []).append(s)

    # PROTO201: sent but unhandled
    for s in senders:
        if handlers and s.kind not in handlers:
            findings.append(Finding(
                rule="PROTO201", path=s.path, line=s.line, symbol=s.symbol,
                key=f"kind:{s.kind}",
                message=f"kind {s.kind!r} is sent here but no "
                        f"{cls_name}.{method} branch handles it — the "
                        f"service will drop this connection as a bad "
                        f"request"))
    # PROTO202: handled but never sent
    for kind, h in handlers.items():
        if kind not in by_kind and kind not in spec.external_kinds:
            findings.append(Finding(
                rule="PROTO202", path=drel_rep, line=h.line, symbol=h.symbol,
                key=f"kind:{kind}",
                message=f"kind {kind!r} has a dispatcher branch but no "
                        f"scanned sender produces it — dead vocabulary, "
                        f"or a sender fell out of the configured scan "
                        f"(declare it in external_kinds if it is ops "
                        f"tooling)"))
    # PROTO203 / PROTO206 per sender site
    for kind, sites in by_kind.items():
        h = handlers.get(kind)
        if h is None:
            continue
        for s in sites:
            if s.fields.open:
                continue
            for f in sorted(h.fields.required):
                if f not in s.fields.all_keys():
                    findings.append(Finding(
                        rule="PROTO203", path=s.path, line=s.line,
                        symbol=s.symbol, key=f"{kind}.{f}",
                        message=f"handler for {kind!r} requires field "
                                f"{f!r} (plain msg[{f!r}] read) but this "
                                f"sender omits it — KeyError server-side, "
                                f"connection dropped"))
            if h.mutating:
                need = ["clock"]
                if "seq" not in h.fields.optional:
                    need.append("seq")
                for f in need:
                    if f not in s.fields.all_keys():
                        findings.append(Finding(
                            rule="PROTO206", path=s.path, line=s.line,
                            symbol=s.symbol, key=f"{kind}.{f}",
                            message=f"{kind!r} accumulates service state "
                                    f"but this sender omits {f!r} — the "
                                    f"exactly-once seq/clock dedup cannot "
                                    f"cover a replay of this message"))
            # PROTO204: reply reads vs produced keys
            if not h.reply.open:
                for f in sorted(s.reply_reads.required):
                    if f not in h.reply.all_keys():
                        findings.append(Finding(
                            rule="PROTO204", path=s.path, line=s.line,
                            symbol=s.symbol, key=f"{kind}.reply.{f}",
                            message=f"client reads reply key {f!r} of "
                                    f"{kind!r} but no handler reply "
                                    f"produces it — KeyError client-side"))

    schema = {
        "dispatcher": f"{drel}:{cls_name}.{method}",
        "kinds": {
            kind: {
                "required_fields": sorted(h.fields.required),
                "optional_fields": sorted(h.fields.optional),
                "reply_keys": sorted(h.reply.all_keys()),
                "reply_open": h.reply.open,
                "mutating": h.mutating,
                "senders": sorted({f"{s.path}:{s.symbol}"
                                   for s in by_kind.get(kind, ())}),
                "sender_fields": sorted(set().union(*(
                    s.fields.all_keys() for s in by_kind.get(kind, ())))
                    if by_kind.get(kind) else set()),
                "client_reads": sorted(set().union(*(
                    s.reply_reads.all_keys()
                    for s in by_kind.get(kind, ())))
                    if by_kind.get(kind) else set()),
            }
            for kind, h in sorted(handlers.items())
        },
        "unhandled_kinds": sorted(k for k in by_kind if k not in handlers),
    }
    return schema, _pragma_filter(findings)


# one-process memo for the DEFAULT extraction: a single CLI run invokes
# it from both run_lints (findings) and the --protocols gate (schema),
# and the sources cannot change mid-process. Custom specs/roots (tests,
# fixtures) bypass the memo entirely.
_default_memo: Optional[Tuple[Dict, List[Finding]]] = None


def extract_schema(services: Sequence[ServiceSpec] = SERVICES,
                   root: str = REPO_ROOT) -> Tuple[Dict, List[Finding]]:
    """The full protocol schema + every PROTO finding (pragma-filtered)."""
    global _default_memo
    is_default = services is SERVICES and root == REPO_ROOT
    if is_default and _default_memo is not None:
        return _default_memo
    schema: Dict = {"comment": "Machine-extracted wire-protocol schema "
                               "(poseidon_tpu.analysis.protocol). Diffed "
                               "in CI; change it with --refresh-schema, "
                               "never by hand.",
                    "services": {}}
    findings: List[Finding] = []
    for spec in services:
        s, f = extract_service(spec, root=root)
        schema["services"][spec.name] = s
        findings.extend(f)
    framing: List[Finding] = []
    for rel in FRAMING_TARGETS:
        path = os.path.join(root, rel)
        if os.path.exists(path):
            framing.extend(lint_framing(path))
    # service findings arrive already pragma-filtered by extract_service;
    # only the framing additions still need the pass (filtering twice
    # would re-read every finding's source file for nothing)
    findings = sorted(findings + _pragma_filter(framing),
                      key=lambda f: (f.path, f.line, f.rule, f.key))
    out = (schema, findings)
    if is_default:
        _default_memo = out
    return out


def run_protocol_lint(root: str = REPO_ROOT) -> List[Finding]:
    return extract_schema(root=root)[1]


# --------------------------------------------------------------------------- #
# schema persistence + diff
# --------------------------------------------------------------------------- #

def load_schema(path: Optional[str] = None) -> Optional[Dict]:
    path = path or SCHEMA_PATH
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_schema(schema: Dict, path: Optional[str] = None) -> str:
    path = path or SCHEMA_PATH
    d = os.path.dirname(path)
    if d:                      # a bare filename has no directory to make
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(schema, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def diff_schema(golden: Dict, fresh: Dict) -> List[str]:
    """Structural old->new diff, one line per changed path. Pure — tests
    feed it synthetic mutations."""
    diffs: List[str] = []

    def walk(prefix: str, g, f) -> None:
        if isinstance(g, dict) and isinstance(f, dict):
            for k in sorted(set(g) | set(f)):
                if k == "comment":
                    continue
                kp = f"{prefix}.{k}" if prefix else k
                if k not in g:
                    walk(kp, None, f[k])
                elif k not in f:
                    walk(kp, g[k], None)
                else:
                    walk(kp, g[k], f[k])
        elif g != f:
            diffs.append(f"{prefix}: {g!r} -> {f!r}")

    walk("", golden, fresh)
    return diffs
