"""RON (Rusty Object Notation) parser/serializer.

Parses the subset of RON emitted by the Rust `ron` crate's pretty serializer,
which is what the reference uses for levels / assets / songs / textures
(the reference's `src/world/level.rs`, `asset/asset.rs`, `tracker/io.rs`).

Mapping to Python:
  * struct / named-field tuple `(a: 1, b: 2)`  -> dict {"a": 1, "b": 2}
  * tuple `(1, 2, 3)`                          -> tuple
  * list `[..]`                                -> list
  * map `{k: v}`                               -> dict with `__ron_map__` key
  * `Some(x)` -> x, `None` -> None
  * unit enum variant `NwSe`                   -> Tag("NwSe")
  * data enum variant `Point(x: 1)` / `Rgb(1,2,3)` -> Tag("Point", payload)
  * numbers -> int/float, strings -> str, true/false -> bool, char -> str
"""

import re
from typing import Any, List, Optional, Tuple

import numpy as _np


class Tag:
    """An enum variant: name plus optional payload."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: Any = None):
        self.name = name
        self.value = value

    def __repr__(self):
        if self.value is None:
            return f"Tag({self.name!r})"
        return f"Tag({self.name!r}, {self.value!r})"

    def __eq__(self, other):
        return (isinstance(other, Tag) and other.name == self.name
                and other.value == self.value)

    def __hash__(self):
        return hash((self.name, repr(self.value)))


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<char>'(?:[^'\\]|\\.)')
  | (?P<number>[+-]?(?:
        0x[0-9a-fA-F_]+
      | (?:\d[\d_]*\.?[\d_]*|\.\d[\d_]*)(?:[eE][+-]?\d+)?
      | inf | NaN
    ))
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>[()\[\]{},:])
""", re.VERBOSE | re.DOTALL)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"', "'": "'",
            "0": "\0"}


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\":
            i += 1
            e = s[i]
            if e == "u":
                # \u{XXXX}
                j = s.index("}", i)
                out.append(chr(int(s[i + 2:j], 16)))
                i = j
            else:
                out.append(_ESCAPES.get(e, e))
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ValueError(f"RON tokenize error at {pos}: {text[pos:pos+40]!r}")
        kind = m.lastgroup
        if kind not in ("ws", "comment"):
            tokens.append((kind, m.group()))
        pos = m.end()
    tokens.append(("eof", ""))
    return tokens


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        k, v = self.next()
        if v != val:
            raise ValueError(f"RON: expected {val!r}, got {v!r}")

    def parse_value(self):
        kind, val = self.peek()
        if kind == "string":
            self.next()
            return _unescape(val[1:-1])
        if kind == "char":
            self.next()
            return _unescape(val[1:-1])
        if kind == "number":
            self.next()
            return self._number(val)
        if kind == "ident":
            self.next()
            if val == "true":
                return True
            if val == "false":
                return False
            if val == "None":
                return None
            if val in ("inf", "NaN"):
                return float(val.lower().replace("nan", "nan"))
            # enum variant or Some(...)
            k2, v2 = self.peek()
            if v2 == "(":
                payload = self._parse_paren()
                if val == "Some":
                    return payload
                return Tag(val, payload)
            return Tag(val)
        if val == "(":
            return self._parse_paren()
        if val == "[":
            return self._parse_list()
        if val == "{":
            return self._parse_map()
        raise ValueError(f"RON: unexpected token {val!r}")

    def _number(self, s):
        s = s.replace("_", "")
        if s.startswith(("0x", "-0x", "+0x")):
            return int(s, 16)
        if "." in s or "e" in s or "E" in s or "inf" in s or "NaN" in s:
            return float(s.replace("NaN", "nan"))
        return int(s)

    def _parse_paren(self):
        """`(...)` — struct (field: value) | tuple | unit ()"""
        self.expect("(")
        if self.peek()[1] == ")":
            self.next()
            return ()
        # Lookahead: ident ':' -> struct fields
        is_struct = False
        if self.peek()[0] == "ident" and self.toks[self.i + 1][1] == ":":
            is_struct = True
        if is_struct:
            out = {}
            while True:
                k, v = self.next()
                if v == ")":
                    break
                assert k == "ident", v
                self.expect(":")
                out[v] = self.parse_value()
                if self.peek()[1] == ",":
                    self.next()
            return out
        items = []
        while True:
            if self.peek()[1] == ")":
                self.next()
                break
            items.append(self.parse_value())
            if self.peek()[1] == ",":
                self.next()
        if len(items) == 1:
            return items[0]  # Some(x)/newtype payload unwraps
        return tuple(items)

    def _parse_list(self):
        self.expect("[")
        out = []
        while True:
            if self.peek()[1] == "]":
                self.next()
                break
            out.append(self.parse_value())
            if self.peek()[1] == ",":
                self.next()
        return out

    def _parse_map(self):
        self.expect("{")
        out = {"__ron_map__": True}
        items = []
        while True:
            if self.peek()[1] == "}":
                self.next()
                break
            k = self.parse_value()
            self.expect(":")
            v = self.parse_value()
            items.append((k, v))
            if self.peek()[1] == ",":
                self.next()
        out["items"] = items
        return out


def loads(text) -> Any:
    """Parse RON text with the C++ parser of native/b32native.cpp (built
    at first use; a failed build raises).  `loads_py` is the pure-Python
    parser, the reference implementation."""
    from .. import native as _native
    return _native.get().ron_loads(text)


def loads_py(text) -> Any:
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    p = _Parser(_tokenize(text))
    v = p.parse_value()
    if p.peek()[0] != "eof":
        raise ValueError("RON: trailing data")
    return v


# =============================================================================
# Serializer (ron::ser pretty-format compatible)
# =============================================================================

def _fmt_float(x: float) -> str:
    if x != x:
        return "NaN"
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    r = repr(float(x))
    if "e" in r or "E" in r or "." in r or "inf" in r or "nan" in r:
        return r
    return r + ".0"


def _dump(v, indent: int, pieces: List[str]):
    pad = "  " * indent
    pad2 = "  " * (indent + 1)
    if v is None:
        pieces.append("None")
    elif v is True:
        pieces.append("true")
    elif v is False:
        pieces.append("false")
    elif isinstance(v, str):
        esc = v.replace("\\", "\\\\").replace('"', '\\"')
        pieces.append(f'"{esc}"')
    elif isinstance(v, float):
        pieces.append(_fmt_float(v))
    elif isinstance(v, int):
        pieces.append(str(v))
    elif isinstance(v, _np.floating):
        # str() of a numpy float is its shortest round-trip decimal.
        s = str(v)
        if "." not in s and "e" not in s and "inf" not in s and "nan" not in s:
            s += ".0"
        pieces.append(s)
    elif isinstance(v, _np.integer):
        pieces.append(str(int(v)))
    elif isinstance(v, Tag):
        pieces.append(v.name)
        if v.name == "Some":
            pieces.append("(")
            _dump(v.value, indent, pieces)
            pieces.append(")")
        elif v.value is not None:
            pieces.append("(")
            if isinstance(v.value, dict) and "__ron_map__" not in v.value:
                pieces.append("\n")
                for k, val in v.value.items():
                    pieces.append(f"{pad2}{k}: ")
                    _dump(val, indent + 1, pieces)
                    pieces.append(",\n")
                pieces.append(pad)
            elif isinstance(v.value, tuple):
                for i, item in enumerate(v.value):
                    if i:
                        pieces.append(", ")
                    _dump(item, indent, pieces)
            else:
                _dump(v.value, indent, pieces)
            pieces.append(")")
    elif isinstance(v, dict):
        if v.get("__ron_map__"):
            pieces.append("{\n")
            for k, val in v["items"]:
                pieces.append(pad2)
                _dump(k, indent + 1, pieces)
                pieces.append(": ")
                _dump(val, indent + 1, pieces)
                pieces.append(",\n")
            pieces.append(pad + "}")
        else:
            pieces.append("(\n")
            for k, val in v.items():
                pieces.append(f"{pad2}{k}: ")
                _dump(val, indent + 1, pieces)
                pieces.append(",\n")
            pieces.append(pad + ")")
    elif isinstance(v, tuple):
        pieces.append("(")
        for i, item in enumerate(v):
            if i:
                pieces.append(", ")
            _dump(item, indent, pieces)
        pieces.append(")")
    elif isinstance(v, list):
        if not v:
            pieces.append("[]")
        else:
            pieces.append("[\n")
            for item in v:
                pieces.append(pad2)
                _dump(item, indent + 1, pieces)
                pieces.append(",\n")
            pieces.append(pad + "]")
    else:
        raise TypeError(f"cannot serialize {type(v)}")


def dumps(v) -> str:
    pieces: List[str] = []
    _dump(v, 0, pieces)
    return "".join(pieces)


def wrap_some(v):
    """Explicitly mark an Option::Some for serialization."""
    return Tag("Some", v) if v is not None else None
