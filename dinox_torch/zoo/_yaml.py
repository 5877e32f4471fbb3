"""A reader for the subset of YAML that the dataset catalog uses, resolved
as ``yaml.safe_load`` (YAML 1.1) resolves it.

Supported: block mappings (nested by indentation) and comments; flow
sequences and flow mappings on one line; plain, single- and double-quoted
scalars on one line; folded ``>`` block scalars with clip chomping (one
trailing newline); ints (decimal, ``0x``, ``0b``, leading-zero octal,
``_`` separators), floats (YAML 1.1 needs the dot), bools (``true``/
``false``/``yes``/``no``/``on``/``off`` in their three cases) and nulls.
Anything else (block sequences, literal ``|`` or chomped/indented block
scalars, multi-line plain or quoted scalars, anchors, aliases, tags,
documents markers, timestamps, sexagesimal numbers, merge keys) raises
``ValueError``.
"""

from __future__ import annotations

import re
from typing import Any

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
            "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# A plain scalar may not start with these (YAML 1.1 indicators; "-", "?"
# and ":" start one only when a non-space follows).
_INDICATORS = set(",[]{}#&*!|>'\"%@`")


def resolve(text: str) -> Any:
    """A plain scalar's value under YAML 1.1's implicit resolvers."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if ":" in v:
            raise ValueError(f"sexagesimal integers are not supported: {text!r}")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        return sign * int(v, 8 if v[0] == "0" else 10)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if ":" in v:
            raise ValueError(f"sexagesimal floats are not supported: {text!r}")
        return float(v.replace(".inf", "inf").replace(".nan", "nan"))
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamps are not supported: {text!r}")
    if text in ("<<", "="):
        raise ValueError(f"the {text!r} key is not supported")
    return text


def _double_quoted(s: str, i: int) -> tuple[str, int]:
    """The double-quoted scalar starting at s[i] == '"'; returns (value, end)."""
    out, i = [], i + 1
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            i += 1
            if i >= len(s):
                break
            e = s[i]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                out.append(chr(int(s[i + 1:i + 1 + n], 16)))
                i += n
            else:
                raise ValueError(f"unknown escape \\{e} in {s!r}")
        else:
            out.append(c)
        i += 1
    raise ValueError(f"unterminated double-quoted scalar (multi-line scalars are not supported): {s!r}")


def _single_quoted(s: str, i: int) -> tuple[str, int]:
    out, i = [], i + 1
    while i < len(s):
        if s[i] == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        out.append(s[i])
        i += 1
    raise ValueError(f"unterminated single-quoted scalar (multi-line scalars are not supported): {s!r}")


def _quoted(s: str, i: int) -> tuple[str, int]:
    return _double_quoted(s, i) if s[i] == '"' else _single_quoted(s, i)


def _check_plain_start(s: str, i: int) -> None:
    c, nxt = s[i], s[i + 1:i + 2]
    if c in _INDICATORS or (c in "-?:" and nxt in ("", " ")):
        raise ValueError(f"unsupported YAML construct at {s[i:]!r}")


def _rest_is_comment(s: str, i: int) -> None:
    rest = s[i:].strip()
    if rest and not rest.startswith("#"):
        raise ValueError(f"unexpected text after a value: {rest!r}")
    if rest and i < len(s) and not s[i].isspace():
        raise ValueError(f"a comment needs a space before '#': {s!r}")


class _Flow:
    """Flow sequences and mappings ([a, b], {k: v}) on one line."""

    def __init__(self, s: str) -> None:
        self.s = s

    def skip(self, i: int) -> int:
        while i < len(self.s) and self.s[i] == " ":
            i += 1
        return i

    def node(self, i: int) -> tuple[Any, int]:
        i = self.skip(i)
        if i >= len(self.s):
            raise ValueError(f"unterminated flow collection (multi-line flows are not supported): {self.s!r}")
        c = self.s[i]
        if c == "[":
            return self.seq(i + 1)
        if c == "{":
            return self.mapping(i + 1)
        if c in "\"'":
            return _quoted(self.s, i)
        return self.plain(i)

    def plain(self, i: int) -> tuple[Any, int]:
        _check_plain_start(self.s, i)
        j = i
        while j < len(self.s):
            c = self.s[j]
            if c in ",[]{}" or (c == ":" and self.s[j + 1:j + 2] in ("", " ", ",", "]", "}", "[", "{")):
                break
            if c == "#" and self.s[j - 1] == " ":
                raise ValueError(f"a comment inside a flow collection is not supported: {self.s!r}")
            j += 1
        return resolve(self.s[i:j].strip()), j

    def seq(self, i: int) -> tuple[list, int]:
        out: list = []
        while True:
            i = self.skip(i)
            if self.s[i:i + 1] == "]":
                return out, i + 1
            item, i = self.node(i)
            i = self.skip(i)
            if self.s[i:i + 1] == ":":
                raise ValueError(f"single-pair mappings in a flow sequence are not supported: {self.s!r}")
            out.append(item)
            if self.s[i:i + 1] == ",":
                i += 1
            elif self.s[i:i + 1] != "]":
                raise ValueError(f"expected ',' or ']' in {self.s!r}")

    def mapping(self, i: int) -> tuple[dict, int]:
        out: dict = {}
        while True:
            i = self.skip(i)
            if self.s[i:i + 1] == "}":
                return out, i + 1
            key, i = self.node(i)
            i = self.skip(i)
            if self.s[i:i + 1] != ":":
                raise ValueError(f"a flow mapping entry needs 'key: value': {self.s!r}")
            value, i = self.node(i + 1)
            out[key] = value
            i = self.skip(i)
            if self.s[i:i + 1] == ",":
                i += 1
            elif self.s[i:i + 1] != "}":
                raise ValueError(f"expected ',' or '}}' in {self.s!r}")


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _blank(line: str) -> bool:
    s = line.strip()
    return not s or s.startswith("#")


def _split_key(content: str) -> tuple[Any, str]:
    """'key: rest' -> (resolved key, rest)."""
    if content[0] in "\"'":
        key, j = _quoted(content, 0)
    else:
        if content.startswith("- ") or content == "-":
            raise ValueError(f"block sequences are not supported: {content!r}")
        _check_plain_start(content, 0)
        m = re.search(r":( |$)", content)
        if m is None:
            raise ValueError(f"expected 'key: value', got {content!r}")
        j = m.start()
        key = resolve(content[:j].rstrip())
    if content[j:j + 1] != ":" or content[j + 1:j + 2] not in ("", " "):
        raise ValueError(f"expected 'key: value', got {content!r}")
    return key, content[j + 1:].strip()


class _Block:
    def __init__(self, lines: list[str]) -> None:
        self.lines = lines

    def next_content(self, i: int) -> int:
        while i < len(self.lines) and _blank(self.lines[i]):
            i += 1
        return i

    def mapping(self, i: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        i = self.next_content(i)
        while i < len(self.lines):
            line = self.lines[i]
            ind = _indent(line)
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"unexpected indentation at line {i + 1}: {line!r}")
            key, rest = _split_key(line[ind:])
            out[key], i = self.value(rest, i, indent)
            i = self.next_content(i)
        return out, i

    def value(self, rest: str, i: int, indent: int) -> tuple[Any, int]:
        """The value of the entry at line i whose text after ': ' is *rest*;
        returns (value, the line after it)."""
        if not rest or rest.startswith("#"):
            j = self.next_content(i + 1)
            if j < len(self.lines) and _indent(self.lines[j]) > indent:
                return self.mapping(j, _indent(self.lines[j]))
            return None, i + 1
        if rest[0] == ">":
            return self.folded(rest, i, indent)
        if rest[0] in "[{":
            value, j = _Flow(rest).node(0)
            _rest_is_comment(rest, j)
        elif rest[0] in "\"'":
            value, j = _quoted(rest, 0)
            _rest_is_comment(rest, j)
        else:
            _check_plain_start(rest, 0)
            text = re.split(r" #", rest, maxsplit=1)[0].rstrip()
            if re.search(r": |:$", text):
                raise ValueError(f"a mapping value is not allowed inside a plain scalar: {rest!r}")
            value = resolve(text)
        j = self.next_content(i + 1)
        if j < len(self.lines) and _indent(self.lines[j]) > indent:
            raise ValueError(f"multi-line scalars are not supported (line {j + 1}: {self.lines[j]!r})")
        return value, i + 1

    def folded(self, header: str, i: int, indent: int) -> tuple[str, int]:
        head = header.split(" #", 1)[0].rstrip()
        if head != ">":
            raise ValueError(f"only the folded '>' block scalar with clip chomping is supported: {header!r}")
        body: list[str] = []
        j = i + 1
        while j < len(self.lines):
            line = self.lines[j]
            if line.strip() and _indent(line) <= indent:
                break
            body.append(line)
            j += 1
        while body and not body[-1].strip():
            body.pop()
        if not body:
            return "", j
        block = min(_indent(ln) for ln in body if ln.strip())
        out: list[str] = []
        empties, first = 0, True
        for ln in body:
            if not ln.strip():
                empties += 1
                continue
            if _indent(ln) > block:
                raise ValueError(f"more-indented lines in a folded scalar are not supported: {ln!r}")
            out.append("\n" * empties if (first or empties) else " ")
            out.append(ln[block:])
            empties, first = 0, False
        return "".join(out) + "\n", j


def safe_load(text: str) -> Any:
    """The document *text* as ``yaml.safe_load`` resolves it, for the
    subset this module reads; ``ValueError`` on anything else."""
    lines = text.splitlines()
    for n, line in enumerate(lines, 1):
        if "\t" in line[:_indent(line) + 1]:
            raise ValueError(f"tab indentation at line {n}")
        if line.startswith(("---", "...", "%")):
            raise ValueError(f"document markers and directives are not supported (line {n})")
    block = _Block(lines)
    start = block.next_content(0)
    if start == len(lines):
        return None
    content = lines[start].strip()
    if content[0] in "[{\"'" or ": " not in content + " ":
        raise ValueError("only a block mapping at the top level is supported")
    out, end = block.mapping(start, _indent(lines[start]))
    if block.next_content(end) != len(lines):
        raise ValueError(f"unexpected text at line {end + 1}: {lines[end]!r}")
    return out
