"""Protobuf text-format parser — the config front-end's foundation (a
copy of ``npairloss_tpu/config/prototxt.py``: the port imports nothing
of the JAX package).

The reference is configured end-to-end in protobuf text format: layer
params via the ``NPairLossParameter`` extension field 8866720
(reference: caffe.proto:2), net topology in usage/def.prototxt, solver
hyperparameters in usage/solver.prototxt.  The north-star requirement is
that those existing prototxt entrypoints keep working, so this module
implements the text-format subset Caffe uses — hand-rolled, no protoc, no
compiled schema:

  * ``key: value`` scalar fields (ints, floats, booleans, quoted strings,
    bare enum identifiers);
  * ``key { ... }`` nested messages (with or without the optional colon);
  * repeated fields: the same key occurring multiple times accumulates
    (e.g. the five ``loss_weight: 1`` entries and three ``mean_value``
    entries of usage/def.prototxt);
  * ``#`` comments to end-of-line, including non-ASCII comment text
    (def.prototxt has Chinese comments);
  * the reference def.prototxt's literal ``.`` ellipsis lines (it is a
    truncated template, SURVEY.md C20) are tolerated at message scope.

The parse result is a :class:`Message`: an ordered multimap that keeps
first-class access to both single (`msg["key"]`) and repeated
(`msg.getlist("key")`) fields, mirroring proto2 semantics where a
singular field takes the LAST occurrence and a repeated field takes all.
"""

from __future__ import annotations

import re
from typing import Any, Iterator, List, Tuple, Union

Scalar = Union[bool, int, float, str]


class Message:
    """Ordered multimap of parsed fields; values are scalars or Messages."""

    __slots__ = ("_fields",)

    def __init__(self):
        self._fields: List[Tuple[str, Any]] = []

    # -- construction ------------------------------------------------------

    def add(self, key: str, value: Any) -> None:
        self._fields.append((key, value))

    # -- proto2-style access ----------------------------------------------

    def getlist(self, key: str) -> List[Any]:
        """All occurrences of ``key``, in file order (repeated semantics)."""
        return [v for k, v in self._fields if k == key]

    def get(self, key: str, default: Any = None) -> Any:
        """Last occurrence of ``key`` (singular proto2 semantics)."""
        vals = self.getlist(key)
        return vals[-1] if vals else default

    def __getitem__(self, key: str) -> Any:
        vals = self.getlist(key)
        if not vals:
            raise KeyError(key)
        return vals[-1]

    def __contains__(self, key: str) -> bool:
        return any(k == key for k, _ in self._fields)

    def keys(self) -> List[str]:
        seen, out = set(), []
        for k, _ in self._fields:
            if k not in seen:
                seen.add(k)
                out.append(k)
        return out

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._fields)

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def to_dict(self) -> dict:
        """Lossy plain-dict view (repeated fields become lists)."""
        out: dict = {}
        for k in self.keys():
            vals = [
                v.to_dict() if isinstance(v, Message) else v
                for v in self.getlist(k)
            ]
            out[k] = vals[0] if len(vals) == 1 else vals
        return out

    def __repr__(self) -> str:
        return f"Message({self.to_dict()!r})"


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<brace>[{}])
  | (?P<colon>:)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_./-]*)
  | (?P<number>[-+]?(?:\.\d+|\d+\.?\d*)(?:[eE][-+]?\d+)?)
  | (?P<ellipsis>\.)
    """,
    re.VERBOSE,
)

_ESCAPES = {
    "n": "\n",
    "t": "\t",
    "r": "\r",
    '"': '"',
    "'": "'",
    "\\": "\\",
}


def _unquote(tok: str) -> str:
    body = tok[1:-1]
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            out.append(_ESCAPES.get(body[i + 1], body[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _tokenize(text: str) -> List[Tuple[str, str, int]]:
    """Yield (kind, token, line_number); comments stripped first."""
    tokens: List[Tuple[str, str, int]] = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        # Strip # comments, but not inside quoted strings.
        stripped, in_str, quote = [], False, ""
        for ch in line:
            if in_str:
                stripped.append(ch)
                if ch == quote and (len(stripped) < 2 or stripped[-2] != "\\"):
                    in_str = False
            elif ch in "\"'":
                in_str, quote = True, ch
                stripped.append(ch)
            elif ch == "#":
                break
            else:
                stripped.append(ch)
        line = "".join(stripped)
        pos = 0
        while pos < len(line):
            if line[pos].isspace() or line[pos] == ",":
                pos += 1
                continue
            m = _TOKEN_RE.match(line, pos)
            if not m:
                raise PrototxtParseError(
                    f"line {lineno}: unexpected character {line[pos]!r}"
                )
            tokens.append((m.lastgroup, m.group(), lineno))
            pos = m.end()
    return tokens


class PrototxtParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


def _coerce_scalar(kind: str, tok: str) -> Scalar:
    if kind == "string":
        return _unquote(tok)
    if kind == "number":
        try:
            return int(tok)
        except ValueError:
            return float(tok)
    # identifier: true/false are proto booleans; anything else stays a
    # string (enum values like GLOBAL, RELATIVE_HARD, phase TRAIN, GPU).
    if tok == "true":
        return True
    if tok == "false":
        return False
    return tok


def parse(text: str) -> Message:
    """Parse prototxt ``text`` into a :class:`Message` tree."""
    tokens = _tokenize(text)
    pos = 0

    def parse_body(depth: int) -> Message:
        nonlocal pos
        msg = Message()
        while pos < len(tokens):
            kind, tok, lineno = tokens[pos]
            if kind == "brace" and tok == "}":
                if depth == 0:
                    raise PrototxtParseError(f"line {lineno}: unmatched '}}'")
                pos += 1
                return msg
            if kind == "ellipsis":
                # Template ellipsis (reference def.prototxt:112-114).
                pos += 1
                continue
            if kind != "ident":
                raise PrototxtParseError(
                    f"line {lineno}: expected field name, got {tok!r}"
                )
            key = tok
            pos += 1
            if pos >= len(tokens):
                raise PrototxtParseError(f"line {lineno}: dangling field {key!r}")
            kind, tok, lineno = tokens[pos]
            if kind == "colon":
                pos += 1
                if pos >= len(tokens):
                    raise PrototxtParseError(
                        f"line {lineno}: missing value for {key!r}"
                    )
                kind, tok, lineno = tokens[pos]
                if kind == "brace" and tok == "{":  # "key: { ... }" form
                    pos += 1
                    msg.add(key, parse_body(depth + 1))
                else:
                    if kind == "brace":
                        raise PrototxtParseError(
                            f"line {lineno}: missing value for {key!r}"
                        )
                    msg.add(key, _coerce_scalar(kind, tok))
                    pos += 1
            elif kind == "brace" and tok == "{":
                pos += 1
                msg.add(key, parse_body(depth + 1))
            else:
                raise PrototxtParseError(
                    f"line {lineno}: expected ':' or '{{' after {key!r}, "
                    f"got {tok!r}"
                )
        if depth != 0:
            raise PrototxtParseError("unexpected end of input: unclosed '{'")
        return msg

    return parse_body(0)


def parse_file(path: str) -> Message:
    with open(path, "r", encoding="utf-8") as f:
        return parse(f.read())


# ---------------------------------------------------------------------------
# Serialization (round-trip support)
# ---------------------------------------------------------------------------


def _format_scalar(v: Scalar) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        # Enum-like bare identifiers round-trip unquoted ONLY via
        # Message-aware callers; a plain string is always quoted here.
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    return repr(v) if isinstance(v, float) else str(v)


_ENUM_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")


def dumps(msg: Message, indent: int = 0) -> str:
    """Serialize a Message back to prototxt text (enum heuristics: bare
    ALL_CAPS identifiers are emitted unquoted, matching Caffe style)."""
    pad = "    " * indent
    lines = []
    for key, value in msg.items():
        if isinstance(value, Message):
            lines.append(f"{pad}{key} {{")
            lines.append(dumps(value, indent + 1))
            lines.append(f"{pad}}}")
        elif isinstance(value, str) and _ENUM_RE.match(value):
            lines.append(f"{pad}{key}: {value}")
        else:
            lines.append(f"{pad}{key}: {_format_scalar(value)}")
    return "\n".join(line for line in lines if line)
