"""Prototxt (protobuf text-format) parser and printer.

Parses the Caffe text format used by Caffe's model zoo
(``models/*/*.prototxt``, schema ``src/caffe/proto/caffe.proto``) into a
generic tree of :class:`Node` objects, without requiring protoc or the
protobuf runtime. Typed adaptation into dataclasses lives in ``messages.py``.

Grammar (the subset the text format actually uses):

    message := field*
    field   := IDENT ':' scalar | IDENT '{' message '}' | IDENT ':' '{' message '}'
    scalar  := NUMBER | STRING | BOOL | ENUM_IDENT | '[' scalar (',' scalar)* ']'

Repeated fields appear as repeated keys.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field
from typing import Any, Iterator, List, Tuple, Union


class PrototxtError(ValueError):
    pass


@dataclass
class Node:
    """A parsed message: ordered multimap of field name -> scalar or Node."""

    fields: List[Tuple[str, Any]] = dc_field(default_factory=list)

    def add(self, name: str, value: Any) -> None:
        self.fields.append((name, value))

    def get_all(self, name: str) -> List[Any]:
        return [v for k, v in self.fields if k == name]

    def get(self, name: str, default: Any = None) -> Any:
        for k, v in self.fields:
            if k == name:
                return v
        return default

    def has(self, name: str) -> bool:
        return any(k == name for k, _ in self.fields)

    def keys(self) -> List[str]:
        return [k for k, _ in self.fields]

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self.fields)


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<number>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|[-+]?inf|nan)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>[{}:\[\],;])
    """,
    re.VERBOSE,
)

_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'", '"': '"',
    "a": "\a", "b": "\b", "f": "\f", "v": "\v", "0": "\0",
}


def _unquote(tok: str) -> str:
    body = tok[1:-1]
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            out.append(_ESCAPES.get(body[i + 1], body[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def tokenize(text: str) -> List[Tuple[str, str]]:
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            line = text.count("\n", 0, pos) + 1
            raise PrototxtError(f"line {line}: unexpected character {text[pos]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append((kind, m.group()))
    return tokens


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> Union[Tuple[str, str], None]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> Tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise PrototxtError("unexpected end of input")
        self.i += 1
        return tok

    def expect_punct(self, p: str) -> None:
        kind, val = self.next()
        if kind != "punct" or val != p:
            raise PrototxtError(f"expected {p!r}, got {val!r}")

    def parse_message(self, terminator: Union[str, None]) -> Node:
        node = Node()
        while True:
            tok = self.peek()
            if tok is None:
                if terminator is None:
                    return node
                raise PrototxtError(f"unexpected end of input, expected {terminator!r}")
            if tok == ("punct", terminator):
                self.next()
                return node
            kind, name = self.next()
            if kind != "ident":
                raise PrototxtError(f"expected field name, got {name!r}")
            tok = self.peek()
            if tok == ("punct", "{"):
                self.next()
                node.add(name, self.parse_message("}"))
            elif tok == ("punct", ":"):
                self.next()
                tok = self.peek()
                if tok == ("punct", "{"):
                    self.next()
                    node.add(name, self.parse_message("}"))
                elif tok == ("punct", "["):
                    self.next()
                    for v in self.parse_list():
                        node.add(name, v)
                else:
                    node.add(name, self.parse_scalar())
            else:
                raise PrototxtError(f"expected ':' or '{{' after {name!r}")
            # optional separators between fields
            while self.peek() in (("punct", ","), ("punct", ";")):
                self.next()

    def parse_list(self) -> List[Any]:
        out: List[Any] = []
        if self.peek() == ("punct", "]"):
            self.next()
            return out
        while True:
            out.append(self.parse_scalar())
            kind, val = self.next()
            if (kind, val) == ("punct", "]"):
                return out
            if (kind, val) != ("punct", ","):
                raise PrototxtError(f"expected ',' or ']' in list, got {val!r}")

    def parse_scalar(self) -> Any:
        kind, val = self.next()
        if kind == "string":
            s = _unquote(val)
            # adjacent string literals concatenate (proto text format rule)
            while self.peek() is not None and self.peek()[0] == "string":
                s += _unquote(self.next()[1])
            return s
        if kind == "number":
            low = val.lower()
            if "inf" in low or "nan" in low or "." in val or "e" in low:
                return float(val)
            return int(val)
        if kind == "ident":
            if val == "true":
                return True
            if val == "false":
                return False
            return val  # enum identifier, kept as string
        raise PrototxtError(f"expected value, got {val!r}")


def parse(text: str) -> Node:
    return _Parser(tokenize(text)).parse_message(None)


def parse_file(path: str) -> Node:
    with open(path, "r") as f:
        return parse(f.read())


def _format_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        # Heuristic: enum identifiers round-trip unquoted only via Node printing
        # of values stored as Enum marker; plain strings are quoted.
        escaped = v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        return f'"{escaped}"'
    if isinstance(v, float):
        return repr(v)
    return str(v)


class Enum(str):
    """Marker for enum identifiers so dumps() emits them unquoted."""


def dumps(node: Node, indent: int = 0) -> str:
    pad = "  " * indent
    lines = []
    for name, value in node:
        if isinstance(value, Node):
            lines.append(f"{pad}{name} {{")
            lines.append(dumps(value, indent + 1))
            lines.append(f"{pad}}}")
        elif isinstance(value, Enum):
            lines.append(f"{pad}{name}: {value}")
        else:
            lines.append(f"{pad}{name}: {_format_scalar(value)}")
    return "\n".join(l for l in lines if l != "")
