"""Reader for the YAML subset that the repo's calibration and config files use.

Supported: nested block maps, block lists (``- item``, including the
kalibr style where the dashes sit at the parent key's indent), flow lists
(``[1, 2, [3, 4]]``, which may span lines), ``#`` comments and scalars
(int, float, ``true``/``false``, ``null``/``~``, quoted and plain strings).
Anything else, such as anchors, flow maps, multi-line strings or maps inside
block lists, raises ``ValueError`` instead of being read wrongly.

Plain scalars follow YAML 1.2 core-schema typing: ``1e-5`` is a float (YAML
1.1 readers keep it a string) and only ``true``/``false`` are booleans.
"""
from __future__ import annotations

import re

_FLOAT = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?")
_INT = re.compile(r"[-+]?\d+")


def load(path: str):
    """Parse the YAML file at ``path``."""
    with open(path) as f:
        return loads(f.read())


def loads(text: str):
    """Parse YAML text; an empty document gives ``None``."""
    lines = _logical_lines(text)
    if not lines:
        return None
    indent, first = lines[0]
    if len(lines) == 1 and not _is_item(first) and not _split_key(first)[1]:
        return _value(first)
    value, pos = _block(lines, 0, indent)
    if pos != len(lines):
        raise ValueError(f"unexpected line: {lines[pos][1]!r}")
    return value


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _depth(text: str) -> int:
    depth, quote = 0, None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _logical_lines(text: str):
    """[(indent, content)] with comments, blank lines and directives
    dropped and multi-line flow collections joined into one line."""
    out = []
    pending = None
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            pending = (pending[0], pending[1] + " " + line.strip())
            if _depth(pending[1]) <= 0:
                out.append(pending)
                pending = None
            continue
        content = line.lstrip(" ")
        if not content or content in ("---", "...") or content.startswith("%"):
            continue
        if content.startswith("\t"):
            raise ValueError("tabs are not valid YAML indentation")
        entry = (len(line) - len(content), content)
        if _depth(content) > 0:
            pending = entry
        else:
            out.append(entry)
    if pending is not None:
        raise ValueError(f"unterminated flow collection: {pending[1]!r}")
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _split_key(text: str):
    """(key, True, rest) for ``key: rest``; (None, False, text) otherwise."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            return _value(text[:i].strip()), True, text[i + 1:].strip()
        elif ch in "[{":
            break
    return None, False, text


def _block(lines, pos, indent):
    if _is_item(lines[pos][1]):
        return _list(lines, pos, indent)
    return _map(lines, pos, indent)


def _child(lines, pos, indent):
    """Value of a key or dash whose own line ends after it: a deeper block,
    a kalibr-style list at the same indent, or null."""
    if pos < len(lines):
        ind, text = lines[pos]
        if ind > indent or (ind == indent and _is_item(text)):
            return _block(lines, pos, ind)
    return None, pos


def _map(lines, pos, indent):
    out = {}
    while pos < len(lines):
        ind, text = lines[pos]
        if ind < indent or (ind == indent and _is_item(text)):
            break
        if ind > indent:
            raise ValueError(f"unexpected indent: {text!r}")
        key, is_pair, rest = _split_key(text)
        if not is_pair:
            raise ValueError(f"expected 'key: value': {text!r}")
        pos += 1
        if rest:
            out[key] = _value(rest)
        else:
            out[key], pos = _child(lines, pos, indent)
    return out, pos


def _list(lines, pos, indent):
    out = []
    while pos < len(lines):
        ind, text = lines[pos]
        if ind != indent or not _is_item(text):
            break
        item = text[1:].strip()
        pos += 1
        if not item:
            value = None
            if pos < len(lines) and lines[pos][0] > indent:
                value, pos = _block(lines, pos, lines[pos][0])
            out.append(value)
        elif _split_key(item)[1]:
            raise ValueError(f"maps inside block lists are not supported: "
                             f"{text!r}")
        else:
            out.append(_value(item))
    return out, pos


def _value(text: str):
    if text.startswith("["):
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after flow list: {text!r}")
        return value
    if text.startswith(("{", "&", "*", "|", ">", "!")):
        raise ValueError(f"unsupported YAML construct: {text!r}")
    return _scalar(text)


def _unquote(text: str) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"unterminated string: {text!r}")
    body = text[1:-1]
    if q == "'":
        return body.replace("''", "'")
    return body.encode("latin-1", "backslashreplace").decode("unicode_escape")


def _scalar(text: str):
    if not text:
        return None
    if text[0] in "'\"":
        return _unquote(text)
    low = text.lower()
    if low in ("null", "~"):
        return None
    if low in ("true", "false"):
        return low == "true"
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    return text


def _flow(text: str, i: int):
    """Parse the flow list starting at text[i] == '['; returns (list, end)."""
    items = []
    i += 1
    n = len(text)
    while True:
        while i < n and text[i] == " ":
            i += 1
        if i >= n:
            raise ValueError(f"unterminated flow list: {text!r}")
        if text[i] == "]":
            return items, i + 1
        if text[i] == "[":
            value, i = _flow(text, i)
        elif text[i] in "'\"":
            j = text.index(text[i], i + 1)
            value, i = _unquote(text[i:j + 1]), j + 1
        elif text[i] == "{":
            raise ValueError(f"flow maps are not supported: {text!r}")
        else:
            j = i
            while j < n and text[j] not in ",]":
                j += 1
            value, i = _scalar(text[i:j].strip()), j
        items.append(value)
        while i < n and text[i] == " ":
            i += 1
        if i < n and text[i] == ",":
            i += 1
        elif i >= n or text[i] != "]":
            raise ValueError(f"malformed flow list: {text!r}")
