"""A loader for the YAML subset the shipped configs use.

Supported: block mappings nested by indentation, block sequences (`- item`),
flow lists and mappings (`[1, [2, 3]]`, `{}`, `{a: 1}`), single- and
double-quoted strings, `#` comments, and plain scalars resolved as YAML 1.1
(`yaml.safe_load`) resolves them: null (`~`, `null`, empty), bools
(`True`, `false`, `yes`, `off`, ...), decimal ints and floats with a dot
(`1e-3` without one stays a string, as in YAML 1.1). Anything else — anchors,
tags, multi-line scalars, multiple documents — raises `ValueError`.
tests/test_miniyaml.py pins equality with `yaml.safe_load` on every config.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOLS = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT_RE = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT_RE = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_SPECIAL_FLOATS = {
    **dict.fromkeys((".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"), float("inf")),
    **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), float("-inf")),
    **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan")),
}
_UNSUPPORTED = ("&", "*", "!", "|", ">", "%", "@", "`")


def _plain_scalar(text: str) -> Any:
    text = text.strip()
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT_RE.match(text):
        return int(text.replace("_", ""))
    if _FLOAT_RE.match(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if text[0] in _UNSUPPORTED:
        raise ValueError(f"unsupported YAML syntax: {text!r}")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """Parse the quoted string starting at text[i]; return (value, end index)."""
    quote, out, i = text[i], [], i + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            esc = text[i + 1 : i + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}[esc])
            i += 2
            continue
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise ValueError(f"unterminated string: {text!r}")


def _strip_comment(line: str) -> str:
    i, quote = 0, None
    while i < len(line):
        c = line[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _flow(text: str, i: int, ends: str) -> Tuple[Any, int]:
    """Parse one flow node at text[i]; plain scalars stop at a char in `ends`."""
    while text[i] == " ":
        i += 1
    c = text[i]
    if c in "[{":
        close = "]" if c == "[" else "}"
        items: List[Any] = []
        mapping = {}
        i += 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == close:
                return (items if c == "[" else mapping), i + 1
            if c == "[":
                value, i = _flow(text, i, ",]")
                items.append(value)
            else:
                key, i = _flow(text, i, ":,}")
                if text[i] != ":":
                    raise ValueError(f"expected ':' in flow mapping: {text!r}")
                value, i = _flow(text, i + 1, ",}")
                mapping[key] = value
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
            elif text[i] != close:
                raise ValueError(f"malformed flow collection: {text!r}")
    if c in "'\"":
        value, i = _quoted(text, i)
        return value, i
    j = i
    while j < len(text) and text[j] not in ends:
        if text[j] == ":" and ":" in ends and text[j + 1 : j + 2] not in (" ", ""):
            j += 1  # a ':' not followed by a space is part of the scalar
            continue
        j += 1
    return _plain_scalar(text[i:j]), j


def _value(text: str) -> Any:
    """A complete inline value: flow collection, quoted string or plain scalar."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "[{'\"":
        try:
            value, end = _flow(text + "\0", 0, "\0")
        except IndexError:
            raise ValueError(f"unterminated flow collection: {text!r}") from None
        if text[end:].strip():
            raise ValueError(f"trailing characters after value: {text!r}")
        return value
    return _plain_scalar(text)


def _split_key(content: str) -> Tuple[str, str]:
    """'key: rest' -> (key, rest); raises if the line is not a mapping entry."""
    if content[0] in "'\"":
        key, end = _quoted(content, 0)
        rest = content[end:]
        if not rest.startswith(":"):
            raise ValueError(f"expected ':' after key: {content!r}")
        return key, rest[1:]
    m = re.match(r"^([^:#]+?)\s*:(?:\s+|$)(.*)$", content)
    if not m:
        raise ValueError(f"expected 'key: value', got {content!r}")
    return m.group(1), m.group(2)


def _block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Any, int]:
    """Parse the block node whose lines start at lines[i] with this indent."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        items = []
        while i < len(lines) and lines[i][0] == indent and lines[i][1][:1] == "-":
            content = lines[i][1][1:].strip()
            if not content or re.match(r"^[^\[{'\"][^:]*:(\s|$)", content):
                raise ValueError(f"only inline sequence items are supported: {content!r}")
            items.append(_value(content))
            i += 1
        return items, i
    mapping = {}
    while i < len(lines) and lines[i][0] == indent:
        key, rest = _split_key(lines[i][1])
        key = _plain_scalar(key) if key.strip() and key[0] not in "'\"" else key
        i += 1
        if rest.strip():
            mapping[key] = _value(rest)
        elif i < len(lines) and (
            lines[i][0] > indent
            or (lines[i][0] == indent and lines[i][1][:1] == "-")
        ):
            mapping[key], i = _block(lines, i, lines[i][0])
        else:
            mapping[key] = None
    return mapping, i


def load(text: str) -> Any:
    """Parse one YAML document of the supported subset (None if it is empty)."""
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            raise ValueError("multi-document YAML is not supported")
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs are not allowed in YAML indentation")
        content = _strip_comment(raw)
        if content.strip():
            lines.append((len(content) - len(content.lstrip(" ")), content.strip()))
    if not lines:
        return None
    first = lines[0][1]
    if len(lines) == 1 and not first.startswith("- ") and (
        first[0] in "[{'\"" or not re.match(r"^[^:]+:(\s|$)", first)
    ):
        return _value(first)
    node, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"bad indentation near: {lines[end][1]!r}")
    return node
