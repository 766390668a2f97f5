"""A reader for the subset of YAML that the training configs and prompt files
use, so the port needs no PyYAML.

It reads block mappings and block sequences nested by indentation (a
sequence item may open a mapping on its own line: `- key: value`), comments,
single- and double-quoted scalars, plain scalars (continued over more
indented lines, folded with one space), and the empty flow collections `[]`
and `{}`. Plain scalars resolve as PyYAML's `safe_load` resolves them (YAML
1.1): null (`~`, `null`, empty), bool (`true`/`false`/`yes`/`no`/`on`/`off`
in their three spellings), decimal int (underscores allowed) and float (with
a dot, as YAML 1.1 requires; `1e-4` stays a string), else str.

Anything else raises `YamlSubsetError` naming the line: anchors, aliases,
tags, block scalars (`|`, `>`), flow collections with content, several
documents, complex keys, and int spellings this reader does not resolve
(octal, hex, binary, sexagesimal).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_UNSUPPORTED_INT = re.compile(
    r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+|[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$"
)
_FLOAT = re.compile(
    r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_KEY = re.compile(r"""("(?:[^"\\]|\\.)*"|'(?:[^']|'')*'|[^'"#\s][^#]*?)\s*:(?:\s+|$)""")


class YamlSubsetError(ValueError):
    pass


@dataclass
class _Line:
    no: int  # 1-based line number
    indent: int
    text: str  # without indentation and trailing comment


def _strip_comment(text: str) -> str:
    """Drop a comment: '#' at the start or after whitespace, outside quotes
    (a backslash escape inside double quotes and a doubled '' inside single
    quotes do not close them)."""
    quote = None
    i = 0
    while i < len(text):
        ch = text[i]
        if quote:
            if quote == '"' and ch == "\\":
                i += 1
            elif ch == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t:-[{,"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _lines(source: str) -> list[_Line]:
    out = []
    for no, raw in enumerate(source.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"line {no}: tabs in indentation are not YAML")
        text = _strip_comment(raw.strip())
        if not text:
            continue
        if text in ("---", "...") or text.startswith(("--- ", "%")):
            raise YamlSubsetError(f"line {no}: document markers and directives are not supported")
        out.append(_Line(no, len(raw) - len(raw.lstrip()), text))
    return out


def _unquote(text: str, no: int) -> str:
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise YamlSubsetError(f"line {no}: unterminated single-quoted scalar")
        return text[1:-1].replace("''", "'")
    if len(text) < 2 or text[-1] != '"':
        raise YamlSubsetError(f"line {no}: unterminated double-quoted scalar")
    body, out, i = text[1:-1], [], 0
    escapes = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0"}
    while i < len(body):
        ch = body[i]
        if ch == "\\":
            if i + 1 >= len(body) or body[i + 1] not in escapes:
                raise YamlSubsetError(f"line {no}: unsupported escape in {text}")
            out.append(escapes[body[i + 1]])
            i += 2
        elif ch == '"':
            raise YamlSubsetError(f"line {no}: stray quote in {text}")
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _plain(text: str, no: int):
    """Resolve a plain scalar as PyYAML's safe_load does."""
    if text in _NULLS:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if text == "[]":
        return []
    if text == "{}":
        return {}
    if text[0] in "&*!|>[{@`%":
        raise YamlSubsetError(f"line {no}: {text!r}: anchors, aliases, tags, block scalars and "
                              "flow collections are not supported")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _UNSUPPORTED_INT.match(text):
        raise YamlSubsetError(f"line {no}: {text!r}: only decimal ints are supported")
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    m = _INF.match(text)
    if m:
        return float("-inf") if m.group(1) == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _scalar(text: str, no: int):
    if text[0] in "'\"":
        return _unquote(text, no)
    return _plain(text, no)


class _Parser:
    def __init__(self, lines: list[_Line]):
        self.lines = lines
        self.pos = 0

    def peek(self):
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def node(self, indent: int):
        """The block node whose lines start at indentation `indent`."""
        line = self.peek()
        if line.text == "-" or line.text.startswith("- "):
            return self.sequence(indent)
        if _KEY.match(line.text):
            return self.mapping(indent)
        self.pos += 1
        return self.continued(line.text, line.no, indent - 1)

    def continued(self, text: str, no: int, parent_indent: int):
        """The scalar `text` on line `no`, with the more-indented continuation
        lines of a plain scalar folded in."""
        value = _scalar(text, no)
        parts = []
        while (nxt := self.peek()) is not None and nxt.indent > parent_indent \
                and not (nxt.text == "-" or nxt.text.startswith("- ")) and not _KEY.match(nxt.text):
            parts.append(nxt.text)
            self.pos += 1
        if not parts:
            return value
        if text[0] in "'\"" or not isinstance(value, str):
            raise YamlSubsetError(f"line {no}: multi-line scalars must be plain strings")
        return " ".join([text, *parts])

    def value_after(self, rest: str, line: _Line, parent_indent: int, of_key: bool):
        """The value of `key: rest` (of_key) or `- rest` on `line`."""
        if rest:
            return self.continued(rest, line.no, parent_indent)
        nxt = self.peek()
        if nxt is not None and nxt.indent > parent_indent:
            return self.node(nxt.indent)
        # a key's sequence may sit at the key's own indentation
        if of_key and nxt is not None and nxt.indent == parent_indent and (
                nxt.text == "-" or nxt.text.startswith("- ")):
            return self.sequence(parent_indent)
        return None

    def mapping(self, indent: int, first: str = None, first_line: _Line = None):
        out = {}
        while True:
            if first is not None:
                text, line, first = first, first_line, None
            else:
                line = self.peek()
                if line is None or line.indent < indent:
                    return out
                if line.indent > indent:
                    raise YamlSubsetError(f"line {line.no}: unexpected indentation")
                if line.text == "-" or line.text.startswith("- "):
                    return out
                text = line.text
                self.pos += 1
            m = _KEY.match(text)
            if m is None:
                raise YamlSubsetError(f"line {line.no}: expected 'key: value', got {text!r}")
            raw_key = m.group(1)
            if raw_key.startswith("? "):
                raise YamlSubsetError(f"line {line.no}: complex keys are not supported")
            key = _scalar(raw_key, line.no)
            if key in out:
                raise YamlSubsetError(f"line {line.no}: duplicate key {key!r}")
            out[key] = self.value_after(text[m.end():].strip(), line, indent, of_key=True)

    def sequence(self, indent: int):
        out = []
        while (line := self.peek()) is not None and line.indent == indent and (
                line.text == "-" or line.text.startswith("- ")):
            self.pos += 1
            rest = line.text[1:].strip()
            if rest.startswith("- "):
                raise YamlSubsetError(f"line {line.no}: nested inline sequences are not supported")
            item_indent = indent + 1 + (len(line.text) - 1 - len(line.text[1:].lstrip()))
            if rest and rest[0] not in "'\"" and _KEY.match(rest):
                out.append(self.mapping(item_indent, rest, line))
            else:
                out.append(self.value_after(rest, line, indent, of_key=False))
        if line is not None and line.indent > indent:
            raise YamlSubsetError(f"line {line.no}: unexpected indentation")
        return out


def loads(source: str):
    """Parse a document of the supported subset; None for an empty one."""
    lines = _lines(source)
    if not lines:
        return None
    parser = _Parser(lines)
    value = parser.node(lines[0].indent)
    rest = parser.peek()
    if rest is not None:
        raise YamlSubsetError(f"line {rest.no}: unexpected content {rest.text!r}")
    return value


def load(path) -> object:
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read())
