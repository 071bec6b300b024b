"""A minimal reader of protobuf text format, enough for Caffe's V1
``NetParameter`` and ``SolverParameter`` files. It is the benchmark's
own: the yardstick does not read the program's parser.

``parse(text)`` returns a :class:`Msg`: each field name maps to the list of
its values in file order; a value is a ``str`` (quoted strings and enum
identifiers), an ``int``, a ``float`` or a nested :class:`Msg`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

_TOKEN = re.compile(r"""
    \s+ | \#[^\n]* |                       # blanks and comments
    (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*') |
    (?P<punct>[{}:<>,;]) |
    (?P<word>[^\s{}:<>,;"'#]+)
""", re.VERBOSE)


class Msg:
    """One message: ``fields[name]`` is the list of that field's values."""

    def __init__(self) -> None:
        self.fields: Dict[str, List[Any]] = {}

    def add(self, key: str, value: Any) -> None:
        self.fields.setdefault(key, []).append(value)

    def all(self, key: str) -> List[Any]:
        return self.fields.get(key, [])

    def get(self, key: str, default: Any = None) -> Any:
        vals = self.fields.get(key)
        return vals[-1] if vals else default

    def msg(self, key: str) -> "Msg":
        """The sub-message ``key``, or an empty one."""
        m = self.get(key)
        return m if isinstance(m, Msg) else Msg()

    def __contains__(self, key: str) -> bool:
        return key in self.fields


def _scalar(word: str) -> Any:
    try:
        return int(word)
    except ValueError:
        pass
    try:
        return float(word)
    except ValueError:
        return word


def _tokens(text: str) -> List[str]:
    out: List[str] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"prototxt: cannot read {text[pos:pos + 30]!r}")
        pos = m.end()
        if m.group("str") is not None:
            out.append(m.group("str"))
        elif m.group("punct") is not None:
            out.append(m.group("punct"))
        elif m.group("word") is not None:
            out.append(m.group("word"))
    return out


def parse(text: str) -> Msg:
    toks = _tokens(text)
    pos = 0

    def message(end: str) -> Msg:
        nonlocal pos
        msg = Msg()
        while pos < len(toks):
            tok = toks[pos]
            if tok == end:
                pos += 1
                return msg
            if tok in (",", ";"):
                pos += 1
                continue
            key = tok
            pos += 1
            if toks[pos] == ":":
                pos += 1
            if toks[pos] in ("{", "<"):
                close = "}" if toks[pos] == "{" else ">"
                pos += 1
                msg.add(key, message(close))
                continue
            val = toks[pos]
            pos += 1
            if val[0] in "\"'":
                msg.add(key, bytes(val[1:-1], "utf-8").decode(
                    "unicode_escape"))
            else:
                msg.add(key, _scalar(val))
        if end != "":
            raise ValueError("prototxt: unbalanced braces")
        return msg

    return message("")


def read(path: str) -> Msg:
    with open(path) as f:
        return parse(f.read())
