"""Protobuf text-format parser/printer — the prototxt substrate.

The reference framework configures *everything* through protobuf text files
("prototxt": net definitions, solver definitions; see
reference src/caffe/proto/caffe.proto and the readers in
reference src/caffe/util/io.cpp). Rather than depending on protoc and a
compiled schema, this module implements the protobuf *text format* grammar
generically: a prototxt file parses into an untyped `PbNode` tree
(field name -> list of scalar values or sub-messages). The typed schema layer
(`caffe_mpi_tpu_torch.proto.config`) then coerces the tree into dataclasses.

This keeps the config layer pure Python, introspectable, and free of codegen,
while accepting the reference's own model files unchanged.
"""

from __future__ import annotations

import math
import re
from typing import Any, Iterator


class PrototxtError(ValueError):
    """Raised on malformed prototxt input, with line/column context."""


class PbEnum(str):
    """A bare identifier value (protobuf enum constant, or true/false).

    Subclasses str so downstream code can compare against e.g. "LMDB"
    directly; `is_enum` marks that the token was unquoted in the source.
    """

    __slots__ = ()


class PbNode:
    """An untyped parsed message: ordered multimap of field name -> values.

    Values are scalars (int, float, bool, str, PbEnum) or nested PbNode.
    Repeated fields accumulate in order of appearance, matching protobuf
    repeated-field semantics.
    """

    __slots__ = ("fields",)

    def __init__(self) -> None:
        self.fields: dict[str, list[Any]] = {}

    # -- mutation ---------------------------------------------------------
    def add(self, name: str, value: Any) -> None:
        self.fields.setdefault(name, []).append(value)

    # -- access -----------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self.fields

    def get_list(self, name: str) -> list[Any]:
        return self.fields.get(name, [])

    def get(self, name: str, default: Any = None) -> Any:
        """Last-wins scalar access (proto2 semantics for optional fields)."""
        vals = self.fields.get(name)
        return vals[-1] if vals else default

    def keys(self) -> Iterator[str]:
        return iter(self.fields.keys())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"PbNode({self.fields!r})"

    def to_text(self, indent: int = 0) -> str:
        """Serialize back to prototxt text."""
        out: list[str] = []
        pad = "  " * indent
        for name, vals in self.fields.items():
            for v in vals:
                if isinstance(v, PbNode):
                    out.append(f"{pad}{name} {{")
                    out.append(v.to_text(indent + 1))
                    out.append(f"{pad}}}")
                else:
                    out.append(f"{pad}{name}: {_format_scalar(v)}")
        return "\n".join(s for s in out if s != "")


def _format_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, PbEnum):
        return str(v)
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        return f'"{escaped}"'
    if isinstance(v, float):
        if math.isinf(v):
            return "inf" if v > 0 else "-inf"
        if math.isnan(v):
            return "nan"
        return repr(v)
    return str(v)


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<punct>[{}:\[\],;<>])
  | (?P<number>
        [-+]?(?:
            0[xX][0-9a-fA-F]+
          | \.\d+(?:[eE][-+]?\d+)?
          | \d+\.\d*(?:[eE][-+]?\d+)?
          | \d+(?:[eE][-+]?\d+)?
        )
        # signed-only inf/nan: unsigned forms tokenize as identifiers so that
        # field names like `infogain_loss_param` are not split mid-word
      | [-+](?:inf(?:inity)?|nan)(?![A-Za-z0-9_.])
    )
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
    """,
    re.VERBOSE,
)

_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"', "'": "'",
    "a": "\a", "b": "\b", "f": "\f", "v": "\v",
}


# One token is a plain (kind, text, pos) tuple — the tokenizer runs for
# every prototxt load (inception_v3: ~80k tokens), and per-token object
# construction / eager newline accounting dominated it. line:col is
# recovered from `pos` by _loc() on the (rare) error paths only.
_Token = tuple


def _loc(src: str, pos: int) -> str:
    line = src.count("\n", 0, pos) + 1
    col = pos - (src.rfind("\n", 0, pos) + 1) + 1
    return f"line {line}:{col}"


def _tokenize(text: str) -> list[_Token]:
    tokens: list[_Token] = []
    append = tokens.append
    pos = 0
    skip = ("ws", "comment")
    for m in _TOKEN_RE.finditer(text):
        if m.start() != pos:
            break  # gap: unmatchable character at `pos`
        kind = m.lastgroup
        if kind not in skip:
            append((kind, m.group(), m.start()))
        pos = m.end()
    if pos != len(text):
        raise PrototxtError(
            f"{_loc(text, pos)}: unexpected character {text[pos]!r}"
        )
    return tokens


def _unquote(s: str) -> str:
    body = s[1:-1]
    out: list[str] = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                i += 2
                continue
            if nxt in "01234567":
                # protobuf octal escape \o, \oo, \ooo (text printer emits
                # these for non-printable bytes)
                j = i + 1
                while j < min(i + 4, len(body)) and body[j] in "01234567":
                    j += 1
                out.append(chr(int(body[i + 1 : j], 8)))
                i = j
                continue
            if nxt == "x":
                j = i + 2
                while j < min(i + 4, len(body)) and body[j] in "0123456789abcdefABCDEF":
                    j += 1
                if j > i + 2:
                    out.append(chr(int(body[i + 2 : j], 16)))
                    i = j
                    continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_number(text: str) -> int | float:
    low = text.lstrip("+-").lower()
    if low.startswith("inf"):
        return math.inf if not text.startswith("-") else -math.inf
    if low == "nan":
        return math.nan
    if low.startswith("0x"):
        sign = -1 if text.startswith("-") else 1
        return sign * int(low, 16)
    if "." in text or "e" in low:
        return float(text)
    return int(text)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, tokens: list[_Token], src: str = ""):
        self.tokens = tokens
        self.src = src
        self.pos = 0

    def peek(self) -> _Token | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> _Token:
        tok = self.peek()
        if tok is None:
            raise PrototxtError("unexpected end of input")
        self.pos += 1
        return tok

    def expect(self, text: str) -> _Token:
        tok = self.next()
        if tok[1] != text:
            raise PrototxtError(
                f"{_loc(self.src, tok[2])}: expected {text!r}, "
                f"got {tok[1]!r}"
            )
        return tok

    def parse_message(self, terminator: str | None) -> PbNode:
        node = PbNode()
        while True:
            tok = self.peek()
            if tok is None:
                if terminator is None:
                    return node
                raise PrototxtError(f"unexpected end of input, expected {terminator!r}")
            if terminator is not None and tok[1] == terminator:
                self.next()
                return node
            if tok[1] in (";", ","):  # optional field separators
                self.next()
                continue
            self.parse_field(node)

    def parse_field(self, node: PbNode) -> None:
        name_tok = self.next()
        if name_tok[0] != "ident":
            raise PrototxtError(
                f"{_loc(self.src, name_tok[2])}: expected field name, "
                f"got {name_tok[1]!r}"
            )
        name = name_tok[1]
        tok = self.peek()
        if tok is None:
            raise PrototxtError(f"unexpected end of input after field {name!r}")
        if tok[1] == "{" or tok[1] == "<":
            self.next()
            node.add(name, self.parse_message("}" if tok[1] == "{" else ">"))
            return
        self.expect(":")
        tok = self.peek()
        if tok is not None and (tok[1] == "{" or tok[1] == "<"):
            # `name: { ... }` is legal text format for message fields
            self.next()
            node.add(name, self.parse_message("}" if tok[1] == "{" else ">"))
            return
        if tok is not None and tok[1] == "[":
            self.next()
            while True:
                t = self.peek()
                if t is None:
                    raise PrototxtError("unterminated list")
                if t[1] == "]":
                    self.next()
                    break
                if t[1] == ",":
                    self.next()
                    continue
                if t[1] == "{" or t[1] == "<":
                    # repeated-message short form: field: [{...}, {...}]
                    self.next()
                    node.add(name, self.parse_message(
                        "}" if t[1] == "{" else ">"))
                else:
                    node.add(name, self.parse_scalar())
            return
        node.add(name, self.parse_scalar())

    def parse_scalar(self) -> Any:
        tok = self.next()
        kind, text = tok[0], tok[1]
        if kind == "string":
            val = _unquote(text)
            # adjacent string literals concatenate (C-style)
            while (nxt := self.peek()) is not None and nxt[0] == "string":
                val += _unquote(self.next()[1])
            return val
        if kind == "number":
            return _parse_number(text)
        if kind == "ident":
            if text == "true":
                return True
            if text == "false":
                return False
            if text.lower() in ("inf", "infinity"):
                return math.inf
            if text.lower() == "nan":
                return math.nan
            return PbEnum(text)
        raise PrototxtError(
            f"{_loc(self.src, tok[2])}: expected value, got {text!r}"
        )


def parse(text: str) -> PbNode:
    """Parse prototxt text into an untyped PbNode tree."""
    return _Parser(_tokenize(text), text).parse_message(None)


def parse_file(path: str) -> PbNode:
    with open(path, "r", encoding="utf-8") as f:
        return parse(f.read())
