"""Reader and writer for the YAML subset that configuration files use.

Covered: block mappings, block sequences of scalars and flow
collections, flow sequences and mappings (`[a, b]`, `{k: v}`), plain,
single- and double-quoted scalars, and `#` comments.  Plain scalars
resolve by the YAML 1.2 core schema: null/~, true/false, integers and
floats (with or without a fraction, e.g. `1e-3`, `1.0e4`, `.inf`); all
else is a string.  Anything outside the subset (anchors, aliases, tags,
block scalars, multi-document streams, multi-line flow collections,
mappings inside block sequences) raises YamlSubsetError instead of being
guessed at.
"""

from __future__ import annotations

import json
import math
import numbers
import re
from typing import Any, List, Tuple

__all__ = ["YamlSubsetError", "load", "dump"]


class YamlSubsetError(ValueError):
    """Input outside the supported YAML subset."""


_INT = re.compile(r"[-+]?[0-9]+\Z")
_FLOAT = re.compile(
    r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?\Z"
)
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)\Z")
_NAN = re.compile(r"\.(nan|NaN|NAN)\Z")
_UNSUPPORTED_START = "&*!|>%@`"
_SAFE_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_ .+\-/()*=<]*\Z")


def _resolve_plain(tok: str) -> Any:
    if tok in ("", "~", "null", "Null", "NULL"):
        return None
    if tok in ("true", "True", "TRUE"):
        return True
    if tok in ("false", "False", "FALSE"):
        return False
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if _INF.match(tok):
        return -math.inf if tok.startswith("-") else math.inf
    if _NAN.match(tok):
        return math.nan
    return tok


def _strip_comment(line: str) -> str:
    """Drop a trailing `# comment` that is outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif quote == "'":
            if c == "'":
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


class _Flow:
    """Recursive-descent parser for one flow node on a single line."""

    def __init__(self, text: str, where: str):
        self.s = text
        self.i = 0
        self.where = where

    def error(self, msg: str) -> YamlSubsetError:
        return YamlSubsetError(f"{self.where}: {msg}: {self.s!r}")

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self, in_flow: bool) -> Any:
        self.ws()
        if self.i >= len(self.s):
            if in_flow:
                raise self.error("unterminated flow collection")
            return None
        c = self.s[self.i]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in "\"'":
            return self.quoted()
        if c in _UNSUPPORTED_START:
            raise self.error(f"'{c}' (anchors, aliases, tags, block "
                             f"scalars) is outside the supported subset")
        stop = ",[]{}" if in_flow else ""
        j = self.i
        while j < len(self.s) and self.s[j] not in stop:
            if in_flow and self.s[j] == ":" and (
                j + 1 == len(self.s) or self.s[j + 1] in " ,}]"
            ):
                break
            j += 1
        tok = self.s[self.i:j].strip()
        self.i = j
        return _resolve_plain(tok)

    def quoted(self) -> str:
        q = self.s[self.i]
        j = self.i + 1
        if q == '"':
            while j < len(self.s) and self.s[j] != '"':
                j += 2 if self.s[j] == "\\" else 1
            if j >= len(self.s):
                raise self.error("unterminated double-quoted string")
            try:
                val = json.loads(self.s[self.i:j + 1])
            except json.JSONDecodeError as exc:
                raise self.error(f"bad escape in string ({exc})") from None
        else:
            parts = []
            while True:
                k = self.s.find("'", j)
                if k < 0:
                    raise self.error("unterminated single-quoted string")
                parts.append(self.s[j:k])
                if k + 1 < len(self.s) and self.s[k + 1] == "'":
                    parts.append("'")
                    j = k + 2
                    continue
                break
            val = "".join(parts)
            j = k
        self.i = j + 1
        return val

    def seq(self) -> List[Any]:
        self.i += 1
        out: List[Any] = []
        self.ws()
        if self.i < len(self.s) and self.s[self.i] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.node(in_flow=True))
            self.ws()
            if self.i >= len(self.s):
                raise self.error("unterminated flow sequence")
            c = self.s[self.i]
            self.i += 1
            if c == "]":
                return out
            if c != ",":
                raise self.error(f"unexpected '{c}' in flow sequence")

    def mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        self.ws()
        if self.i < len(self.s) and self.s[self.i] == "}":
            self.i += 1
            return out
        while True:
            key = self.node(in_flow=True)
            self.ws()
            if self.i >= len(self.s) or self.s[self.i] != ":":
                raise self.error("expected ':' in flow mapping")
            self.i += 1
            if _key(key) in out:
                raise self.error(f"duplicate key {key!r}")
            out[_key(key)] = self.node(in_flow=True)
            self.ws()
            if self.i >= len(self.s):
                raise self.error("unterminated flow mapping")
            c = self.s[self.i]
            self.i += 1
            if c == "}":
                return out
            if c != ",":
                raise self.error(f"unexpected '{c}' in flow mapping")

    def value(self) -> Any:
        """The whole text as one node; trailing content is an error."""
        v = self.node(in_flow=False)
        self.ws()
        if self.i != len(self.s):
            raise self.error("unexpected trailing content")
        return v


def _key(k: Any) -> Any:
    if isinstance(k, (list, dict)):
        raise YamlSubsetError(f"collection used as a mapping key: {k!r}")
    return k


def _split_key(body: str, where: str) -> Tuple[Any, str]:
    """Split `key: rest` at the first mapping colon outside quotes."""
    if body[:1] in "\"'":
        p = _Flow(body, where)
        key = p.quoted()
        rest = body[p.i:]
        if not (rest == ":" or rest.startswith(": ")):
            raise YamlSubsetError(f"{where}: expected ':' after quoted key")
        return key, rest[1:].strip()
    m = re.search(r":( |\Z)", body)
    if m is None:
        raise YamlSubsetError(f"{where}: expected 'key: value'")
    key = body[:m.start()].strip()
    if not key or key[0] in "[{?" or key[0] in _UNSUPPORTED_START:
        raise YamlSubsetError(f"{where}: unsupported key {key!r}")
    return _resolve_plain(key), body[m.end():].strip()


def load(text: str) -> Any:
    """Parse `text`; an empty document gives None."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        body = _strip_comment(raw)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t") or "\t" in body[: len(body) - len(stripped)]:
            raise YamlSubsetError(f"{where}: tab in indentation")
        if stripped.startswith(("---", "...", "%")):
            raise YamlSubsetError(
                f"{where}: document markers and directives are outside "
                f"the supported subset"
            )
        lines.append((len(body) - len(stripped), stripped, where))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlSubsetError(f"{lines[i][2]}: unexpected indentation")
    return value


def _is_item(body: str) -> bool:
    return body == "-" or body.startswith("- ")


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    if _is_item(lines[i][1]):
        out: List[Any] = []
        while i < len(lines) and lines[i][0] == indent and _is_item(
            lines[i][1]
        ):
            _, body, where = lines[i]
            rest = body[1:].strip()
            if re.search(r":( |\Z)", rest) and rest[:1] not in "[{\"'":
                raise YamlSubsetError(
                    f"{where}: mappings inside block sequences are "
                    f"outside the supported subset"
                )
            i += 1
            if rest:
                out.append(_Flow(rest, where).value())
            elif i < len(lines) and lines[i][0] > indent:
                val, i = _block(lines, i, lines[i][0])
                out.append(val)
            else:
                out.append(None)
        return out, i
    out_map: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        _, body, where = lines[i]
        if _is_item(body):
            raise YamlSubsetError(f"{where}: sequence item inside a mapping")
        key, rest = _split_key(body, where)
        key = _key(key)
        if key in out_map:
            raise YamlSubsetError(f"{where}: duplicate key {key!r}")
        i += 1
        if rest:
            out_map[key] = _Flow(rest, where).value()
        elif i < len(lines) and (
            lines[i][0] > indent
            or (lines[i][0] == indent and _is_item(lines[i][1]))
        ):
            out_map[key], i = _block(lines, i, lines[i][0])
        else:
            out_map[key] = None
    return out_map, i


# -- writer ----------------------------------------------------------------


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, numbers.Integral):
        return str(int(v))
    if isinstance(v, numbers.Real):
        f = float(v)
        if math.isnan(f):
            return ".nan"
        if math.isinf(f):
            return ".inf" if f > 0 else "-.inf"
        r = repr(f)
        mant, e, exp = r.partition("e")
        if "." not in mant:  # keep a fraction: 1e-12 -> 1.0e-12
            mant += ".0"
        return mant + e + exp
    if isinstance(v, str):
        if (
            _SAFE_PLAIN.match(v)
            and not v.endswith(" ")
            and isinstance(_resolve_plain(v), str)
        ):
            return v
        return json.dumps(v)
    raise YamlSubsetError(f"cannot write {type(v).__name__} value {v!r}")


def _flow(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(
            f"{_scalar(k)}: {_flow(x)}" for k, x in v.items()
        ) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def dump(data: dict) -> str:
    """Write a mapping: nested non-empty mappings in block style, every
    other value (sequences included) in flow style on one line."""
    lines: List[str] = []

    def emit(d: dict, indent: int):
        for k, v in d.items():
            key = " " * indent + _scalar(k) + ":"
            if isinstance(v, dict) and v:
                lines.append(key)
                emit(v, indent + 2)
            else:
                lines.append(key + " " + _flow(v))

    if not isinstance(data, dict):
        raise YamlSubsetError("the top level must be a mapping")
    emit(data, 0)
    return "\n".join(lines) + "\n"
