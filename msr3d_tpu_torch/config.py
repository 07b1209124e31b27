"""Config system: YAML + ``${a.b.c}`` interpolation + dotlist CLI overrides.

Counterpart of ``msr3d_tpu/config.py``. The JAX package reads its YAML with
PyYAML, which the GPU host does not have, so this module parses the subset
of YAML that ``configs/*.yaml`` use by itself:

  * block mappings and block sequences (``- item``, compact ``- - x`` and
    ``- key: value`` included), flow sequences and flow mappings
    (``[3, 64, 64, 128]``, ``[]``, ``{}``);
  * plain, single- and double-quoted strings, folded over lines;
  * YAML 1.1 scalars as PyYAML's ``SafeLoader`` resolves them (``null``/``~``,
    ``True``/``yes``/``off`` and the other booleans, decimal, octal ``0..``,
    hex and binary ints, ``.inf``/``.nan``) plus the YAML 1.2 floats without
    a dot that the JAX loader adds (``3e-5``, ``configs/msr3d.yaml:45``);
  * comments and empty values (``exp_dir: ""``, ``key:`` is null).

Anything else (anchors and aliases, tags, block scalars ``|``/``>``,
complex keys, directives, several documents, timestamps and sexagesimal
numbers) raises ``YamlSubsetError`` with its line number.

Public API:
    cfg = load_config(path, overrides=["a.b=3", "c=foo"])
    cfg.model.name            # attribute access
    cfg.get('key', default)   # dict-style access with default
    cfg2dict(cfg)             # plain-dict container
    save_config(cfg, path)    # YAML that this loader and PyYAML read back alike
"""

from __future__ import annotations

import copy
import json
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------


class YamlSubsetError(ValueError):
    """Input outside the YAML subset this loader reads, or malformed."""

    def __init__(self, msg: str, line: Optional[int] = None):
        super().__init__(f"line {line}: {msg}" if line is not None else msg)


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT_RES = (
    (re.compile(r"[-+]?0b[0-1_]+"), 2),
    (re.compile(r"[-+]?0x[0-9a-fA-F_]+"), 16),
    (re.compile(r"[-+]?0[0-7_]+"), 8),
    (re.compile(r"[-+]?(?:0|[1-9][0-9_]*)"), 10),
)
# SafeLoader's float (a dot required) and the YAML 1.2 floats the JAX loader
# adds (config.py:38-48 there): the union of the two resolvers
_FLOAT_RE = re.compile(
    r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?""",
    re.X,
)
_INF_RE = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN_RE = re.compile(r"\.(?:nan|NaN|NAN)")
# resolved by PyYAML to datetimes and base-60 numbers: outside the subset
_UNSUPPORTED_RE = re.compile(
    r"[0-9]{4}-[0-9]{2}-[0-9]{2}"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}"
    r"(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
)
_DQ_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
    "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xa0", "L": " ", "P": " ",
}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}


def _resolve_plain(text: str, line: int) -> Any:
    """A plain scalar → the value PyYAML's resolver would give it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    for rx, base in _INT_RES:
        if rx.fullmatch(text):
            digits = text.replace("_", "")
            sign = -1 if digits[0] == "-" else 1
            digits = digits.lstrip("+-")
            if base != 10:
                digits = digits[2:] if base in (2, 16) else digits[1:]
            return sign * int(digits or "0", base)
    if _FLOAT_RE.fullmatch(text):
        return float(text.replace("_", ""))
    if _INF_RE.fullmatch(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN_RE.fullmatch(text):
        return math.nan
    if _UNSUPPORTED_RE.fullmatch(text):
        raise YamlSubsetError(f"timestamps and base-60 numbers are outside the subset: "
                              f"{text!r}", line)
    if text[0] in "&*!|>%@`" or text.startswith(("? ", "- ")) or text in ("-", "?"):
        raise YamlSubsetError(f"unsupported YAML construct at {text!r} (anchors, aliases, "
                              "tags, block scalars and complex keys are outside the subset)",
                              line)
    return text


def _unquote(text: str, line: int) -> str:
    """A complete single- or double-quoted scalar (quotes included), folded
    lines already joined."""
    quote, body = text[0], text[1:-1]
    if quote == "'":
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        esc = body[i + 1] if i + 1 < len(body) else ""
        if esc in _DQ_ESCAPES:
            out.append(_DQ_ESCAPES[esc])
            i += 2
        elif esc in _DQ_HEX:
            n = _DQ_HEX[esc]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise YamlSubsetError(f"unknown escape \\{esc} in a double-quoted string", line)
    return "".join(out)


def _quoted_end(text: str, start: int) -> int:
    """Index just past the closing quote of the quoted scalar at ``start``,
    or -1 if it does not close in ``text``."""
    quote, i = text[start], start + 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if i + 1 < len(text) and text[i + 1] == "'":
                i += 2
                continue
            return i + 1
        if quote == '"':
            if ch == "\\":
                i += 2
                continue
            if ch == '"':
                return i + 1
        i += 1
    return -1


def _strip_comment(text: str) -> str:
    """Drop a ``#`` comment (at the start or after whitespace, outside
    quotes) and trailing whitespace."""
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            end = _quoted_end(text, i)
            if end < 0:
                return text.rstrip()  # continues on the next line
            i = end
            continue
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _fold(parts: List[str]) -> str:
    """YAML line folding: lines join with a space, an empty line is a newline."""
    out = ""
    for i, part in enumerate(parts):
        if i == 0:
            out = part
        elif part == "":
            out += "\n"
        elif out.endswith("\n") or not out:
            out += part
        else:
            out += " " + part
    return out


class _FlowParser:
    """``[a, b, [c]]`` and ``{k: v}`` on one logical line."""

    def __init__(self, text: str, line: int):
        self.s, self.i, self.line = text, 0, line

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def parse(self) -> Any:
        value = self._value()
        self._ws()
        if self.i != len(self.s):
            raise YamlSubsetError(f"unexpected text after a flow collection: "
                                  f"{self.s[self.i:]!r}", self.line)
        return value

    def _value(self) -> Any:
        self._ws()
        if self.i >= len(self.s):
            raise YamlSubsetError("unterminated flow collection", self.line)
        ch = self.s[self.i]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in "'\"":
            end = _quoted_end(self.s, self.i)
            if end < 0:
                raise YamlSubsetError("unterminated quoted string", self.line)
            text, self.i = self.s[self.i:end], end
            return _unquote(text, self.line)
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in ",[]{}" and not (
                self.s[self.i] == ":" and self.s[self.i + 1:self.i + 2] in (" ", "")):
            self.i += 1
        return _resolve_plain(self.s[start:self.i].strip(), self.line)

    def _seq(self) -> List[Any]:
        self.i += 1
        out: List[Any] = []
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self._value())
            self._ws()
            ch = self.s[self.i:self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != "]":
                raise YamlSubsetError(f"expected ',' or ']' in a flow sequence: "
                                      f"{self.s!r}", self.line)

    def _map(self) -> Dict[Any, Any]:
        self.i += 1
        out: Dict[Any, Any] = {}
        while True:
            self._ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self._value()
            self._ws()
            if self.s[self.i:self.i + 1] != ":":
                raise YamlSubsetError(f"expected ':' in a flow mapping: {self.s!r}", self.line)
            self.i += 1
            self._ws()
            value = None if self.s[self.i:self.i + 1] in (",", "}") else self._value()
            out[key] = value
            self._ws()
            ch = self.s[self.i:self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != "}":
                raise YamlSubsetError(f"expected ',' or '}}' in a flow mapping: "
                                      f"{self.s!r}", self.line)


def _flow_balance(text: str) -> int:
    """Open brackets minus closed ones, outside quotes."""
    depth, i = 0, 0
    while i < len(text):
        ch = text[i]
        if ch in "'\"":
            end = _quoted_end(text, i)
            if end < 0:
                return depth
            i = end
            continue
        depth += (ch in "[{") - (ch in "]}")
        i += 1
    return depth


_Line = Tuple[int, int, str]  # (line number, indent, content)


class _BlockParser:
    def __init__(self, text: str):
        self.lines: List[_Line] = []
        for no, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YamlSubsetError("tabs in indentation", no)
            stripped = raw.strip()
            if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
                raise YamlSubsetError("document markers and directives are outside the subset",
                                      no)
            content = _strip_comment(raw.lstrip())
            indent = len(raw) - len(raw.lstrip())
            self.lines.append((no, indent, content))
        self.pos = 0

    # -- helpers -----------------------------------------------------------

    def _skip_blank(self) -> None:
        while self.pos < len(self.lines) and not self.lines[self.pos][2]:
            self.pos += 1

    def _peek(self) -> Optional[_Line]:
        self._skip_blank()
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def parse(self) -> Any:
        first = self._peek()
        if first is None:
            return None
        value = self._node(first[1])
        rest = self._peek()
        if rest is not None:
            raise YamlSubsetError(f"unexpected indentation or content: {rest[2]!r}", rest[0])
        return value

    @staticmethod
    def _is_seq_item(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    @staticmethod
    def _split_key(content: str, no: int) -> Optional[Tuple[Any, str]]:
        """``key: rest`` → (key, rest); None when the line is no mapping entry."""
        if content[0] in "'\"":
            end = _quoted_end(content, 0)
            if end < 0 or content[end:end + 1] != ":" or content[end + 1:end + 2] not in ("", " "):
                return None
            return _unquote(content[:end], no), content[end + 1:].strip()
        if content[0] in "[{":
            return None
        m = re.search(r":(?: |$)", content)
        if m is None:
            return None
        key = content[:m.start()].strip()
        if not key:
            raise YamlSubsetError("empty mapping key", no)
        return _resolve_plain(key, no), content[m.end():].strip()

    # -- nodes -------------------------------------------------------------

    def _node(self, indent: int) -> Any:
        line = self._peek()
        no, ind, content = line
        if self._is_seq_item(content):
            return self._seq(ind)
        if self._split_key(content, no) is not None:
            return self._map(ind)
        self.pos += 1
        return self._scalar(content, no, ind - 1)

    def _seq(self, indent: int) -> List[Any]:
        out: List[Any] = []
        while True:
            line = self._peek()
            if line is None or line[1] != indent or not self._is_seq_item(line[2]):
                if line is not None and line[1] > indent:
                    raise YamlSubsetError(f"bad indentation: {line[2]!r}", line[0])
                return out
            no, _, content = line
            rest = content[1:].lstrip()
            if not rest:  # "-" alone: the item is the indented block below (or null)
                self.pos += 1
                nxt = self._peek()
                out.append(self._node(nxt[1]) if nxt is not None and nxt[1] > indent else None)
                continue
            # the item's content starts a block at its own column
            col = indent + (len(content) - len(rest))
            self.lines[self.pos] = (no, col, rest)
            out.append(self._node(col))

    def _map(self, indent: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while True:
            line = self._peek()
            if line is None or line[1] < indent:
                return out
            no, ind, content = line
            if ind > indent:
                raise YamlSubsetError(f"bad indentation: {content!r}", no)
            if self._is_seq_item(content):
                return out  # a sequence at the parent's indent (handled above)
            split = self._split_key(content, no)
            if split is None:
                raise YamlSubsetError(f"expected 'key: value', got {content!r}", no)
            key, rest = split
            self.pos += 1
            if rest:
                out[key] = self._scalar(rest, no, indent)
                continue
            nxt = self._peek()
            if nxt is not None and (nxt[1] > indent or (
                    nxt[1] == indent and self._is_seq_item(nxt[2]))):
                out[key] = self._node(nxt[1])
            else:
                out[key] = None

    def _scalar(self, text: str, no: int, parent_indent: int) -> Any:
        """A value on the line of its key or dash; flow collections and
        quoted or plain scalars may continue on more-indented lines."""
        if text[0] in "[{":
            while _flow_balance(text) > 0:
                nxt = self._continuation(parent_indent)
                if nxt is None:
                    raise YamlSubsetError("unterminated flow collection", no)
                text += " " + nxt
            return _FlowParser(text, no).parse()
        if text[0] in "'\"":
            parts = [text]
            while _quoted_end(" ".join(parts), 0) < 0:
                nxt = self._continuation(parent_indent, allow_blank=True)
                if nxt is None:
                    raise YamlSubsetError("unterminated quoted string", no)
                parts.append(nxt)
            joined = parts[0] if len(parts) == 1 else _fold(
                [parts[0].rstrip()] + [p.strip() for p in parts[1:]])
            end = _quoted_end(joined, 0)
            if joined[end:].strip():
                raise YamlSubsetError(f"unexpected text after a quoted string: {joined!r}", no)
            return _unquote(joined[:end], no)
        if self._split_key(text, no) is not None:
            raise YamlSubsetError(f"a mapping on the line of its key is outside the subset: "
                                  f"{text!r}", no)
        parts = [text]
        while True:
            nxt = self._continuation(parent_indent, allow_blank=True, plain=True)
            if nxt is None:
                break
            parts.append(nxt)
        while parts and parts[-1] == "":
            parts.pop()
        return _resolve_plain(_fold(parts), no)

    def _continuation(self, parent_indent: int, allow_blank: bool = False,
                      plain: bool = False) -> Optional[str]:
        """The next line's content if it continues the current scalar (more
        indented than its parent), else None; blank lines continue a quoted
        or plain scalar only if a continuation follows them."""
        i = self.pos
        blanks = 0
        while i < len(self.lines) and not self.lines[i][2]:
            i += 1
            blanks += 1
        if i >= len(self.lines) or self.lines[i][1] <= parent_indent:
            return None
        no, _, content = self.lines[i]
        if plain and (self._is_seq_item(content) or self._split_key(content, no) is not None):
            raise YamlSubsetError(f"bad indentation: {content!r}", no)
        if blanks and allow_blank:
            self.pos += 1  # consume one blank line: a newline in the folded value
            return ""
        self.pos = i + 1
        return content


def yaml_load(text: str) -> Any:
    """Parse a YAML document of the subset (see the module docstring)."""
    return _BlockParser(text).parse()


# -- dumping -----------------------------------------------------------------

_PLAIN_SAFE_RE = re.compile(r"[A-Za-z0-9_./$()\-][A-Za-z0-9_./${}()\- ]*")


def _dump_scalar(v: Any, flow: bool = False) -> str:
    """``flow``: inside a flow sequence, where ``,[]{}`` end a plain scalar."""
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
        return repr(v)
    if not isinstance(v, str):
        raise TypeError(f"cannot write {type(v).__name__} to YAML")
    plain = _PLAIN_SAFE_RE.fullmatch(v) and v == v.strip() and " #" not in v
    if plain and not (flow and any(c in v for c in ",[]{}")):
        try:
            if yaml_load(v) == v:
                return v
        except YamlSubsetError:
            pass
    if any(ord(c) < 32 or ord(c) == 127 for c in v):
        return json.dumps(v, ensure_ascii=False)  # JSON escapes are YAML escapes
    return "'" + v.replace("'", "''") + "'"


def _is_flow(v: Any) -> bool:
    return not isinstance(v, dict) and (not isinstance(v, list) or all(map(_is_flow, v)))


def _dump_flow(v: Any, flow: bool = False) -> str:
    if isinstance(v, list):
        return "[" + ", ".join(_dump_flow(x, flow=True) for x in v) + "]"
    return _dump_scalar(v, flow)


def _dump_node(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for key, val in v.items():
            k = _dump_scalar(key)
            if isinstance(val, dict) and val:
                out.append(f"{pad}{k}:")
                _dump_node(val, indent + 2, out)
            elif isinstance(val, list) and val and not _is_flow(val):
                out.append(f"{pad}{k}:")
                _dump_node(val, indent + 2, out)
            elif isinstance(val, dict):
                out.append(f"{pad}{k}: {{}}")
            else:
                out.append(f"{pad}{k}: {_dump_flow(val)}")
    elif isinstance(v, list):
        for item in v:
            if isinstance(item, (dict, list)) and item and not _is_flow(item):
                out.append(f"{pad}-")
                _dump_node(item, indent + 2, out)
            elif isinstance(item, dict):
                out.append(f"{pad}- {{}}")
            else:
                out.append(f"{pad}- {_dump_flow(item)}")
    else:
        out.append(pad + _dump_flow(v))


def yaml_dump(data: Any) -> str:
    """Block mappings, flow sequences of scalars and sequences, block
    sequences where an item is a mapping."""
    out: List[str] = []
    _dump_node(data, 0, out)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# the config object
# ---------------------------------------------------------------------------


class Config:
    """Attribute-accessible nested config with lazy ``${...}`` interpolation.

    Wraps a plain dict. Interpolations are resolved against the *root* dict
    at access time, so forward references and override-then-resolve both work.
    """

    __slots__ = ("_data", "_root")

    def __init__(self, data: Dict[str, Any], root: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_root", root if root is not None else data)

    # -- resolution ---------------------------------------------------------

    def _resolve_path(self, dotted: str) -> Any:
        node: Any = self._root
        for part in dotted.split("."):
            if isinstance(node, dict):
                if part not in node:
                    raise KeyError(f"interpolation key not found: ${{{dotted}}}")
                node = node[part]
            elif isinstance(node, (list, tuple)):
                node = node[int(part)]
            else:
                raise KeyError(f"cannot descend into {type(node)} at ${{{dotted}}}")
        return self._resolve_value(node)

    def _resolve_value(self, v: Any) -> Any:
        if isinstance(v, str):
            m = _INTERP_RE.fullmatch(v)
            if m:  # whole-string interpolation: preserve referenced type
                return self._resolve_path(m.group(1))
            if "${" in v:  # embedded interpolation: string substitution
                return _INTERP_RE.sub(lambda m: str(self._resolve_path(m.group(1))), v)
            return v
        if isinstance(v, dict):
            return Config(v, self._root)
        if isinstance(v, list):
            return [self._resolve_value(x) for x in v]
        return v

    # -- access -------------------------------------------------------------

    def __getattr__(self, key: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if key in data:
            return self._resolve_value(data[key])
        raise AttributeError(f"config has no key {key!r}; available: {list(data)}")

    def __getitem__(self, key: str) -> Any:
        return self.__getattr__(key)

    def __setattr__(self, key: str, value: Any) -> None:
        if isinstance(value, Config):
            value = value.to_dict()
        self._data[key] = value

    __setitem__ = __setattr__

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)

    def __eq__(self, other) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self._resolve_value(self._data[key])
        return default

    def keys(self):
        return self._data.keys()

    def values(self):
        return [self._resolve_value(v) for v in self._data.values()]

    def items(self):
        return [(k, self._resolve_value(v)) for k, v in self._data.items()]

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self._data[key] = default
        return self._resolve_value(self._data[key])

    def to_dict(self) -> Dict[str, Any]:
        """Fully-resolved plain-dict container."""

        def conv(v: Any) -> Any:
            if isinstance(v, Config):
                return {k: conv(val) for k, val in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return {k: conv(self._resolve_value(v)) for k, v in self._data.items()}

    def __repr__(self) -> str:
        return f"Config({json.dumps(self.to_dict(), indent=2, default=str)})"


def _parse_scalar(text: str) -> Any:
    """Parse an override RHS as a YAML document ('3' → int, 'true' → bool,
    '[]' → [], '' → None); text outside the subset stays a string."""
    try:
        return yaml_load(text)
    except YamlSubsetError:
        return text


def apply_overrides(data: Dict[str, Any], overrides: List[str]) -> None:
    """Apply Hydra-style ``key.path=value`` dotlist overrides in place."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        parts = key.strip().split(".")
        node = data
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"cannot override through non-dict at {p!r} in {key!r}")
        node[parts[-1]] = _parse_scalar(raw)


def load_config(path: str | Path, overrides: Optional[List[str]] = None) -> Config:
    data = yaml_load(Path(path).read_text()) or {}
    if overrides:
        apply_overrides(data, overrides)
    return Config(data)


def config_from_dict(data: Dict[str, Any]) -> Config:
    return Config(copy.deepcopy(data))


def cfg2dict(cfg: Any) -> Dict[str, Any]:
    """Resolve a Config (or pass through a dict) into a plain container."""
    if isinstance(cfg, Config):
        return cfg.to_dict()
    return cfg


def save_config(cfg: Config, path: str | Path) -> None:
    """Save the fully-resolved config snapshot."""
    Path(path).write_text(yaml_dump(cfg2dict(cfg)))
