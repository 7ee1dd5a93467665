"""Vehicle parameter loading from the bundled YAML asset files.

The assets (and a user's ``model_dir`` files) are read by ``parse_yaml``, a
reader for the subset of YAML they use: block maps, block lists (including
lists of maps), flow lists of scalars, comments, and plain or simply quoted
scalars resolved as YAML 1.1's safe loader resolves them (int, float, bool,
null, string). Anything else raises ``ValueError`` with the line number.
"""

from __future__ import annotations

import copy
import functools
import os
import re
from typing import Any

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_FLOAT = re.compile(
    r"[-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?|\.[0-9_]+([eE][-+][0-9]+)?"
)
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)")
_NAN = re.compile(r"\.(nan|NaN|NAN)")
_KEY = re.compile(r"([A-Za-z0-9_][A-Za-z0-9_ .\-]*?):(?: +(.*))?$")
_SPECIAL = set("[]{}&*!|>%@`,")


def _fail(lineno: int, msg: str):
    raise ValueError(f"YAML line {lineno}: {msg}")


def _scalar(tok: str, lineno: int) -> Any:
    t = tok.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        inner = t[1:-1]
        if t[0] in inner or "\\" in inner:
            _fail(lineno, f"unsupported quoting in {t!r}")
        return inner
    if t in _NULL:
        return None
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    if _INT.fullmatch(t):
        return int(t.replace("_", ""))
    if _FLOAT.fullmatch(t):
        return float(t.replace("_", ""))
    if _INF.fullmatch(t):
        return float("-inf") if t[0] == "-" else float("inf")
    if _NAN.fullmatch(t):
        return float("nan")
    if t[0] in _SPECIAL or t[0] in "'\"" or ": " in t:
        _fail(lineno, f"unsupported value {t!r}")
    return t


def _flow_list(text: str, lineno: int) -> list:
    """``[a, b, [c, d]]`` of scalars (nested flow lists allowed)."""
    pos = 0

    def peek() -> str:
        while pos < len(text) and text[pos] == " ":
            advance()
        if pos >= len(text):
            _fail(lineno, f"unterminated flow list {text!r}")
        return text[pos]

    def advance():
        nonlocal pos
        pos += 1

    def parse() -> list:
        advance()  # "["
        out: list = []
        if peek() == "]":
            advance()
            return out
        while True:
            if peek() == "[":
                out.append(parse())
            else:
                start = pos
                while pos < len(text) and text[pos] not in ",[]":
                    advance()
                out.append(_scalar(text[start:pos], lineno))
            ch = peek()
            advance()
            if ch == "]":
                return out
            if ch != ",":
                _fail(lineno, f"expected ',' or ']' in {text!r}")

    result = parse()
    if text[pos:].strip():
        _fail(lineno, f"trailing text after flow list {text!r}")
    return result


def _value(text: str, lineno: int) -> Any:
    text = text.strip()
    if text.startswith("["):
        return _flow_list(text, lineno)
    return _scalar(text, lineno)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " [,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _lines(text: str) -> list[tuple[int, str, int]]:
    """Non-blank lines with comments stripped: (indent, content, lineno)."""
    items = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            _fail(lineno, "tab indentation")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            _fail(lineno, "document markers are not supported")
        content = line.lstrip(" ")
        items.append((len(line) - len(content), content, lineno))
    return items


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: list, i: int, indent: int) -> tuple[Any, int]:
    if _is_item(lines[i][1]):
        return _seq(lines, i, indent)
    return _map(lines, i, indent)


def _nested(lines: list, i: int, indent: int, allow_seq_same: bool):
    """Value of a ``key:`` / ``-`` with nothing after it: the indented block
    that follows (a block list may sit at the key's own indent), or None."""
    if i < len(lines):
        ind, content, _ = lines[i]
        if ind > indent or (allow_seq_same and ind == indent and _is_item(content)):
            return _block(lines, i, ind)
    return None, i


def _map(lines: list, i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        _, content, lineno = lines[i]
        m = _KEY.match(content)
        if not m:
            _fail(lineno, f"expected 'key: value', got {content!r}")
        key, rest = m.group(1), m.group(2)
        if key in out:
            _fail(lineno, f"duplicate key {key!r}")
        if rest is None or not rest.strip():
            out[key], i = _nested(lines, i + 1, indent, True)
        else:
            out[key], i = _value(rest, lineno), i + 1
    if i < len(lines) and lines[i][0] > indent:
        _fail(lines[i][2], "unexpected indentation")
    return out, i


def _seq(lines: list, i: int, indent: int) -> tuple[list, int]:
    out: list = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        _, content, lineno = lines[i]
        rest = content[1:].lstrip(" ")
        if not rest:
            value, i = _nested(lines, i + 1, indent, False)
        elif _KEY.match(rest) and not rest.startswith(("[", "'", '"')):
            # "- key: v" opens a map whose keys sit at the text's column
            col = indent + len(content) - len(rest)
            lines[i] = (col, rest, lineno)
            value, i = _map(lines, i, col)
        else:
            value, i = _value(rest, lineno), i + 1
        out.append(value)
    if i < len(lines) and lines[i][0] > indent:
        _fail(lines[i][2], "unexpected indentation")
    return out, i


def parse_yaml(text: str) -> Any:
    """Parses the YAML subset described in the module docstring."""
    lines = _lines(text)
    if not lines:
        return None
    if lines[0][0] != 0:
        _fail(lines[0][2], "document must start at column 0")
    value, i = _block(lines, 0, 0)
    if i != len(lines):
        _fail(lines[i][2], "unexpected content")
    return value


@functools.lru_cache(maxsize=None)
def _load_yaml_cached(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return parse_yaml(f.read())


def load_vehicle_yaml(name: str, model_dir: str | None = None) -> dict:
    """Loads ``<model_dir>/<name>.yaml`` (defaults to the bundled assets).

    Returns a deep copy so callers can tweak nested parameter sections
    without poisoning the process-wide cache.
    """
    directory = model_dir or os.path.join(ASSET_DIR, "vehicles")
    return copy.deepcopy(_load_yaml_cached(os.path.join(directory, f"{name}.yaml")))
