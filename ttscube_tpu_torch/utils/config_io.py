"""The checkpoint `.yaml` files of the JAX package, read and written without `yaml`.

The JAX trainer writes `{base}.yaml` with `yaml.dump` of a small dict
(`ttscube_tpu/utils/checkpoint.py::save_config`: sample_rate, hop_size, conditioning
and, for LM-conditioned models, lm_config). This module reads the subset that
`yaml.dump` emits for such dicts, and writes it as `yaml.dump` does:

  * block mappings, nested by indentation, keys sorted on writing;
  * block lists, at the mapping's own indentation or deeper, items scalars, mappings
    or lists ("- - 1");
  * `{}` and `[]` for an empty mapping or list;
  * scalars: null (`null`, `~`, nothing), bools (true/false/yes/no/on/off in YAML
    1.1's spellings), decimal ints, floats in YAML 1.1's form (`1.0`, `1.5e-05`,
    `.inf`, `.nan`), plain strings, and single- or double-quoted strings on one line;
  * blank lines and whole-line comments.

Anything else (anchors, aliases, tags, flow collections, block scalars, documents,
multi-line scalars, numbers in any other notation, tabs) raises ValueError naming the
line: a config is never guessed at.
"""

from __future__ import annotations

import math
import os
import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?\Z")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)\Z")
_NAN = re.compile(r"\.(nan|NaN|NAN)\Z")
# a plain scalar that starts like a number but is none of the forms above (octal,
# hex, sexagesimal, underscores, an exponent without a sign) is refused
_NUMBERLIKE = re.compile(r"[-+]?\.?[0-9]")
_INDICATORS = "&*!|>{[]}%@`,"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


class _Lines:
    def __init__(self, text: str, where: str):
        self.where = where
        self.items = []  # (line number, indent, content)
        for no, raw in enumerate(text.splitlines(), 1):
            line = raw.rstrip()
            stripped = line.lstrip(" ")
            if not stripped or stripped.startswith("#"):
                continue
            if "\t" in line[: len(line) - len(stripped) + 1]:
                self.fail(no, "tabs in indentation")
            if stripped in ("---", "...") or stripped.startswith("%"):
                self.fail(no, "documents and directives are not read")
            self.items.append([no, len(line) - len(stripped), stripped])

    def fail(self, no: int, what: str):
        raise ValueError(f"{self.where}:{no}: {what}: not in the yaml subset that "
                         "checkpoint configs use")


def _quoted(lines: _Lines, no: int, s: str) -> tuple:
    """A quoted scalar at the start of s: (its value, the rest of s)."""
    q = s[0]
    out, i = [], 1
    while i < len(s):
        ch = s[i]
        if q == "'" and ch == "'":
            if s[i + 1: i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), s[i + 1:]
        if q == '"' and ch == '"':
            return "".join(out), s[i + 1:]
        if q == '"' and ch == "\\":
            e = s[i + 1: i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(e)
            code = s[i + 2: i + 2 + width] if width else ""
            if not width or not re.fullmatch(r"[0-9a-fA-F]+", code) or len(code) != width:
                lines.fail(no, f"escape \\{e}")
            out.append(chr(int(code, 16)))
            i += 2 + width
            continue
        out.append(ch)
        i += 1
    lines.fail(no, "a quoted scalar that does not end on its line")


def _scalar(lines: _Lines, no: int, s: str):
    """The value of one scalar written on one line."""
    if s[:1] in ("'", '"'):
        value, rest = _quoted(lines, no, s)
        if rest.strip() and not rest.strip().startswith("#"):
            lines.fail(no, f"text after a quoted scalar: {rest!r}")
        return value
    if s in ("{}", "[]"):
        return {} if s == "{}" else []
    if s[:1] in _INDICATORS or s.startswith(("- ", "? ", ": ")) or s == "-":
        lines.fail(no, f"{s!r} (anchor, alias, tag, flow collection or block scalar)")
    if " #" in s or ": " in s or s.endswith(":"):
        lines.fail(no, f"{s!r} (a comment or a mapping inside a plain scalar)")
    if s in _NULL:
        return None
    if s in _TRUE or s in _FALSE:
        return s in _TRUE
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    if _INF.match(s):
        return -math.inf if s.startswith("-") else math.inf
    if _NAN.match(s):
        return math.nan
    if _NUMBERLIKE.match(s):
        lines.fail(no, f"{s!r} (a number in a notation this reader does not take)")
    return s


def _split_key(lines: _Lines, no: int, s: str):
    """(key, value text) of a `key: value` or `key:` line, or None if s is no such line."""
    if s[:1] in ("'", '"'):
        key, rest = _quoted(lines, no, s)
        if not (rest == ":" or rest.startswith(": ")):
            return None  # a quoted scalar, not a key
        return key, rest[1:].strip()
    if s.endswith(":") and ": " not in s:
        return _scalar(lines, no, s[:-1]), ""
    if ": " in s:
        k, v = s.split(": ", 1)
        return _scalar(lines, no, k), v.strip()
    return None


def _node(lines: _Lines, i: int, indent: int):
    """The node whose first line is lines[i], at `indent`: (value, next index)."""
    no, ind, s = lines.items[i]
    if s == "-" or s.startswith("- "):
        return _sequence(lines, i, indent)
    if _split_key(lines, no, s) is not None:
        return _mapping(lines, i, indent)
    if i + 1 < len(lines.items) and lines.items[i + 1][1] > indent:
        lines.fail(lines.items[i + 1][0], "a scalar that goes on over several lines")
    return _scalar(lines, no, s), i + 1


def _child(lines: _Lines, i: int, indent: int, same_level_list: bool):
    """The value that follows `key:` or `-` with nothing after it on line i − 1."""
    if i < len(lines.items):
        no, ind, s = lines.items[i]
        if ind > indent:
            return _node(lines, i, ind)
        if same_level_list and ind == indent and (s == "-" or s.startswith("- ")):
            return _sequence(lines, i, indent)
    return None, i


def _mapping(lines: _Lines, i: int, indent: int):
    out = {}
    while i < len(lines.items):
        no, ind, s = lines.items[i]
        if ind < indent:
            break
        if ind > indent:
            lines.fail(no, "unexpected indentation")
        if s == "-" or s.startswith("- "):
            break  # a list item at this level ends the mapping (it belongs to a parent)
        kv = _split_key(lines, no, s)
        if kv is None:
            lines.fail(no, f"{s!r} is not a 'key: value' line")
        key, rest = kv
        if not isinstance(key, (str, int, float, bool)) or key in out:
            lines.fail(no, f"key {key!r} is repeated or not a scalar")
        if rest:
            out[key] = _scalar(lines, no, rest)
            i += 1
        else:
            out[key], i = _child(lines, i + 1, indent, same_level_list=True)
    return out, i


def _sequence(lines: _Lines, i: int, indent: int):
    out = []
    while i < len(lines.items):
        no, ind, s = lines.items[i]
        if ind < indent or not (s == "-" or s.startswith("- ")):
            if ind > indent:
                lines.fail(no, "unexpected indentation")
            break
        if ind > indent:
            lines.fail(no, "unexpected indentation")
        rest = s[1:]
        if not rest.strip():
            value, i = _child(lines, i + 1, indent, same_level_list=False)
        else:
            # the item's content, as if it stood on its own line at its own column
            inner = indent + 1 + (len(rest) - len(rest.lstrip(" ")))
            lines.items[i] = [no, inner, rest.lstrip(" ")]
            value, i = _node(lines, i, inner)
        out.append(value)
    return out, i


def loads(text: str, where: str = "<yaml>"):
    """The value of a yaml document in the subset above (None for an empty one)."""
    lines = _Lines(text, where)
    if not lines.items:
        return None
    indent = lines.items[0][1]
    value, i = _node(lines, 0, indent)
    if i != len(lines.items):
        lines.fail(lines.items[i][0], "text after the document's top-level node")
    return value


def load(path: str):
    with open(path) as f:
        return loads(f.read(), where=path)


# -- writing --------------------------------------------------------------------------

_PLAIN = re.compile(r"[A-Za-z_/][A-Za-z0-9_./:+' -]*(?<! )\Z")


def _fmt_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v).lower()  # PyYAML's float form: 1e+20 → 1.0e+20
        return r.replace("e", ".0e", 1) if "." not in r and "e" in r else r
    if isinstance(v, str):
        if (_PLAIN.match(v) and v not in _NULL | _TRUE | _FALSE and not v.endswith(":")
                and ": " not in v and " #" not in v):
            return v
        if all(" " <= ch <= "~" for ch in v):
            return "'" + v.replace("'", "''") + "'"
        raise ValueError(f"string {v!r} is outside the yaml subset written here")
    raise ValueError(f"{type(v).__name__} {v!r} is outside the yaml subset written here")


def _dump(v, indent: int, out: list, lead: str) -> None:
    """Append the lines of v; `lead` is what precedes it on its first line ("key:" or
    a run of "- ")."""
    pad = " " * indent
    if isinstance(v, dict) and v:
        first = True
        for k in sorted(v):
            key = _fmt_scalar(k)
            prefix = (lead if first else pad) + key + ":"
            first = False
            item = v[k]
            if isinstance(item, dict) and item:
                out.append(prefix)
                _dump(item, indent + 2, out, " " * (indent + 2))
            elif isinstance(item, list) and item:
                out.append(prefix)
                _dump(item, indent, out, pad)
            else:
                out.append(prefix + " " + _fmt_scalar_or_empty(item))
    elif isinstance(v, list) and v:
        first = True
        for item in v:
            prefix = (lead if first else pad) + "- "
            first = False
            if isinstance(item, (dict, list)) and item:
                _dump(item, indent + 2, out, prefix)
            else:
                out.append(prefix + _fmt_scalar_or_empty(item))
    else:
        out.append(lead + _fmt_scalar_or_empty(v))


def _fmt_scalar_or_empty(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _fmt_scalar(v)


def dumps(value) -> str:
    """yaml.dump's text for a dict (or list, or scalar) of the subset above."""
    out: list = []
    _dump(value, 0, out, "")
    return "\n".join(out) + "\n"


def dump(value, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(dumps(value))
