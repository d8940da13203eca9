"""Experiment settings persistence (the ``settings.yaml`` round trip)
without pyyaml.

Port of ``superresolution_aniso_mri_tpu/config/settings.py``. Settings
are a flat mapping of str keys to str / int / float / bool / None values
(numpy scalars are taken as their Python values). ``dump_settings``
writes exactly the bytes of ``yaml.safe_dump(d, sort_keys=True)`` for
such a mapping: PyYAML's scalar analysis, its implicit resolvers (a
string that would read back as another type is quoted), its float
spelling and its folding at width 80. ``parse_settings`` reads what it
writes. Anything else (nested values, lists, other types, YAML the
emitter never writes) raises ``ValueError``.

Dataset split files are a mapping of lists of patient ids:
``dump_string_lists`` writes ``yaml.safe_dump``'s bytes for such a
mapping, and ``parse_string_lists`` reads it in block or flow style.
"""
from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

_STR, _INT, _FLOAT, _BOOL, _NULL, _OTHER = ("str", "int", "float", "bool",
                                            "null", "other")

# PyYAML's implicit resolvers (yaml/resolver.py), in registration order,
# with the first characters each is tried for
_RESOLVERS = [
    (_BOOL, re.compile(r'''^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$''', re.X), 'yYnNtTfFoO'),
    (_FLOAT, re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X), '-+0123456789.'),
    (_INT, re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X),
     '-+0123456789'),
    (_OTHER, re.compile(r'^(?:<<)$'), '<'),
    (_NULL, re.compile(r'''^(?: ~
                    |null|Null|NULL
                    | )$''', re.X), '~nN'),
    (_OTHER, re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''',
                        re.X), '0123456789'),
    (_OTHER, re.compile(r'^(?:=)$'), '='),
    (_OTHER, re.compile(r'^(?:!|&|\*)$'), '!&*'),
]

_BREAKS = '\n\x85\u2028\u2029'
_WHITESPACE = '\0 \t\r\n\x85\u2028\u2029'
_BEST_WIDTH = 80
_INDENT = 2          # continuation lines of a mapping value
_ESCAPES = {'\0': '0', '\x07': 'a', '\x08': 'b', '\x09': 't', '\x0A': 'n',
            '\x0B': 'v', '\x0C': 'f', '\x0D': 'r', '\x1B': 'e', '"': '"',
            '\\': '\\', '\x85': 'N', '\xA0': '_', '\u2028': 'L',
            '\u2029': 'P'}
_UNESCAPES = {v: k for k, v in _ESCAPES.items()}
_UNESCAPES[" "] = " "        # the escaped space a folded line starts with


def _resolve(value: str) -> str:
    """The tag a plain scalar ``value`` reads back as."""
    for tag, regexp, first in _RESOLVERS:
        if (value[:1] in first if value else tag == _NULL) \
                and regexp.match(value):
            return tag
    return _STR


# ---------------------------------------------------------------------------
# emitter
# ---------------------------------------------------------------------------

def _represent(key: str, value) -> tuple:
    """(text, is_str) of a settings value, as PyYAML's SafeRepresenter
    spells it."""
    if isinstance(value, np.generic):
        value = value.item()
    if value is None:
        return "null", False
    if isinstance(value, bool):
        return ("true" if value else "false"), False
    if isinstance(value, int):
        return str(value), False
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan", False
        if math.isinf(value):
            return (".inf" if value > 0 else "-.inf"), False
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, False
    if isinstance(value, str):
        return value, True
    raise ValueError(f"settings key {key!r}: {type(value).__name__} values "
                     f"are not supported (flat str/int/float/bool/None only)")


def _analyze(s: str) -> dict:
    """PyYAML's ``Emitter.analyze_scalar`` (allow_unicode=False)."""
    if not s:
        return dict(empty=True, multiline=False, block_plain=True,
                    single_quoted=True)
    block_ind = s.startswith("---") or s.startswith("...")
    line_breaks = special = False
    leading_space = leading_break = trailing_space = trailing_break = False
    break_space = space_break = False
    preceded_ws = True
    followed_ws = len(s) == 1 or s[1] in _WHITESPACE
    prev_space = prev_break = False
    for i, ch in enumerate(s):
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                block_ind = True
            if ch in "?:" and followed_ws:
                block_ind = True
            if ch == "-" and followed_ws:
                block_ind = True
        else:
            if ch == ":" and followed_ws:
                block_ind = True
            if ch == "#" and preceded_ws:
                block_ind = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
            special = True
        if ch == " ":
            leading_space |= i == 0
            trailing_space |= i == len(s) - 1
            break_space |= prev_break
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            leading_break |= i == 0
            trailing_break |= i == len(s) - 1
            space_break |= prev_space
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded_ws = ch in _WHITESPACE
        followed_ws = i + 2 >= len(s) or s[i + 2] in _WHITESPACE
    block_plain = single_quoted = True
    if leading_space or leading_break or trailing_space or trailing_break:
        block_plain = False
    if break_space:
        block_plain = single_quoted = False
    if space_break or special:
        block_plain = single_quoted = False
    if line_breaks or block_ind:
        block_plain = False
    return dict(empty=False, multiline=line_breaks, block_plain=block_plain,
                single_quoted=single_quoted)


class _Writer:
    """The part of PyYAML's ``Emitter`` that writes one block mapping of
    scalars: ``write_plain``, ``write_single_quoted``,
    ``write_double_quoted``, ``write_indent`` and the indicators, with
    their column and whitespace bookkeeping."""

    def __init__(self):
        self.out: List[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent = 0

    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def line_break(self, data: str = "\n") -> None:
        self.whitespace = self.indention = True
        self.column = 0
        self.out.append(data)

    def write_indent(self) -> None:
        if (not self.indention or self.column > self.indent
                or (self.column == self.indent and not self.whitespace)):
            self.line_break()
        if self.column < self.indent:
            self.whitespace = True
            self.write(" " * (self.indent - self.column))

    def indicator(self, ind: str, need_whitespace: bool) -> None:
        self.write(ind if self.whitespace or not need_whitespace
                   else " " + ind)
        self.whitespace = False
        self.indention = False

    def scalar(self, text: str, is_str: bool, split: bool) -> None:
        a = _analyze(text)
        implicit = (not is_str) or _resolve(text) == _STR
        if implicit and a["block_plain"] and not (
                not split and (a["empty"] or a["multiline"])):
            self.plain(text, split)
        elif a["single_quoted"] and not (not split and a["multiline"]):
            self.single_quoted(text, split)
        else:
            self.double_quoted(text, split)

    def _breaks(self, text: str, start: int, end: int) -> None:
        if text[start] == "\n":
            self.line_break()
        for br in text[start:end]:
            self.line_break("\n" if br == "\n" else br)
        self.write_indent()

    def plain(self, text: str, split: bool) -> None:
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if (start + 1 == end and self.column > _BEST_WIDTH
                            and split):
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self._breaks(text, start, end)
                    self.whitespace = self.indention = False
                    start = end
            elif ch is None or ch in " " + _BREAKS:
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
            end += 1

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > _BEST_WIDTH
                            and split and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self._breaks(text, start, end)
                    start = end
            elif ch is None or ch in " " + _BREAKS or ch == "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
            end += 1
        self.indicator("'", False)

    def double_quoted(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if (ch is None or ch in '"\\\x85\u2028\u2029\ufeff'
                    or not "\x20" <= ch <= "\x7E"):
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _ESCAPES:
                        self.write("\\" + _ESCAPES[ch])
                    elif ch <= "\xFF":
                        self.write("\\x%02X" % ord(ch))
                    elif ch <= "\uffff":
                        self.write("\\u%04X" % ord(ch))
                    else:
                        self.write("\\U%08X" % ord(ch))
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > _BEST_WIDTH and split):
                self.write(text[start:end] + "\\")
                if start < end:
                    start = end
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.indicator('"', False)


def _check_keys(mapping: Dict[str, Any]) -> None:
    for key in mapping:
        if not isinstance(key, str):
            raise ValueError(f"settings key {key!r}: keys must be str")
        # PyYAML writes a key of 123+ characters (with its '!!str' tag)
        # or with a line break as a complex '? ' key
        if not key or any(ch in _BREAKS for ch in key) or len(key) > 122:
            raise ValueError(f"settings key {key!r}: keys must be one "
                             f"non-empty line of at most 122 characters")


def dump_settings(settings: Dict[str, Any]) -> str:
    """``yaml.safe_dump(settings, sort_keys=True)`` of a flat mapping."""
    _check_keys(settings)
    if not settings:
        return "{}\n"
    w = _Writer()
    for key in sorted(settings):
        text, is_str = _represent(key, settings[key])
        w.write_indent()
        w.scalar(key, True, split=False)
        w.indicator(":", False)
        w.indent = _INDENT
        w.scalar(text, is_str, split=True)
        w.indent = 0
    w.write_indent()
    return "".join(w.out)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

def _construct_int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        total, base = 0, 1
        for part in reversed([int(p) for p in v.split(":")]):
            total += part * base
            base *= 60
        return sign * total
    return sign * int(v)


def _construct_float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        total, base = 0.0, 1
        for part in reversed([float(p) for p in v.split(":")]):
            total += part * base
            base *= 60
        return sign * total
    return sign * float(v)


def _plain_value(key: str, text: str):
    tag = _resolve(text)
    if tag == _STR:
        return text
    if tag == _NULL:
        return None
    if tag == _BOOL:
        return text.lower() in ("yes", "true", "on")
    if tag == _INT:
        return _construct_int(text)
    if tag == _FLOAT:
        return _construct_float(text)
    raise ValueError(f"settings key {key!r}: plain value {text!r} is not a "
                     f"flat str/int/float/bool/None")


def _fold(lines: List[str]) -> str:
    """YAML line folding of a multi-line quoted scalar's raw lines: a
    break between two non-empty lines is a space, each empty line a
    newline; whitespace around breaks is dropped."""
    if len(lines) == 1:
        return lines[0]
    out = lines[0].rstrip(" \t")
    i = 1
    while i < len(lines):
        empty = 0
        while i < len(lines) - 1 and not lines[i].strip(" \t"):
            empty += 1
            i += 1
        seg = lines[i].lstrip(" \t")
        if i < len(lines) - 1:
            seg = seg.rstrip(" \t")
        out += ("\n" * empty if empty else " ") + seg
        i += 1
    return out


class _Reader:
    takes = "the settings reader takes a flat mapping of scalars"

    def __init__(self, text: str, where: str):
        self.s = text
        self.i = 0
        self.where = where

    def error(self, msg: str) -> ValueError:
        line = self.s.count("\n", 0, self.i) + 1
        return ValueError(f"{self.where}: line {line}: {msg} ({self.takes})")

    def single_quoted(self) -> str:
        self.i += 1
        raw = []
        while True:
            if self.i >= len(self.s):
                raise self.error("unterminated single-quoted scalar")
            ch = self.s[self.i]
            if ch == "'":
                if self.s.startswith("''", self.i):
                    raw.append("\x00SQ")
                    self.i += 2
                    continue
                self.i += 1
                break
            raw.append(ch)
            self.i += 1
        return _fold("".join(raw).split("\n")).replace("\x00SQ", "'")

    def double_quoted(self) -> str:
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise self.error("unterminated double-quoted scalar")
            ch = self.s[self.i]
            if ch == '"':
                self.i += 1
                return "".join(out)
            if ch == "\n":
                raise self.error("unescaped line break in a double-quoted "
                                 "scalar")
            if ch != "\\":
                out.append(ch)
                self.i += 1
                continue
            esc = self.s[self.i + 1:self.i + 2]
            self.i += 2
            if esc == "\n":                    # escaped break: join lines
                while self.s[self.i:self.i + 1] in (" ", "\t"):
                    self.i += 1
            elif esc in _UNESCAPES:
                out.append(_UNESCAPES[esc])
            elif esc in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[esc]
                digits = self.s[self.i:self.i + n]
                if len(digits) != n or not all(
                        c in "0123456789abcdefABCDEF" for c in digits):
                    raise self.error(f"bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                self.i += n
            else:
                raise self.error(f"unknown escape \\{esc}")

    def plain(self, stop_at_colon: bool) -> str:
        """A plain scalar to the end of its line (a key: to ': '), with
        the more-indented continuation lines of a value folded in."""
        end = self.s.find("\n", self.i)
        end = len(self.s) if end < 0 else end
        if stop_at_colon:
            m = re.compile(r":(?= |\n|$)").search(self.s, self.i, end)
            if m is None:
                raise self.error("expected 'key: value'")
            text, self.i = self.s[self.i:m.start()], m.start()
            return text
        lines = [self.s[self.i:end]]
        self.i = end
        while self.s.startswith("\n ", self.i):
            nxt = self.s.find("\n", self.i + 1)
            nxt = len(self.s) if nxt < 0 else nxt
            lines.append(self.s[self.i + 1:nxt])
            self.i = nxt
        return _fold(lines).strip(" \t")

    def scalar(self, key: Optional[str]):
        """(value, quoted): a key when ``key`` is None, else its value."""
        ch = self.s[self.i:self.i + 1]
        if ch == "'":
            return self.single_quoted(), True
        if ch == '"':
            return self.double_quoted(), True
        if key is not None and ch in ("", "\n"):
            return "", False
        if ch in "[]{}&*!|>%@`#,":
            raise self.error(f"unsupported YAML ({ch!r} starts "
                             f"{'a value' if key is not None else 'a key'})")
        return self.plain(stop_at_colon=key is None), False


def parse_settings(text: str, where: str = "settings") -> Dict[str, Any]:
    """Read a flat settings mapping (what ``dump_settings`` writes)."""
    if text.strip() == "{}":
        return {}
    r = _Reader(text, where)
    out: Dict[str, Any] = {}
    while r.i < len(r.s):
        if r.s[r.i] == "\n":
            r.i += 1
            continue
        if r.s[r.i] in " \t" or r.s.startswith(("- ", "-\n"), r.i):
            raise r.error("nested or sequence content")
        key, quoted = r.scalar(None)
        if not quoted:
            key = key.rstrip(" \t")
            if _resolve(key) != _STR:
                raise r.error(f"non-string key {key!r}")
        if not r.s.startswith(":", r.i):
            raise r.error("expected ':' after the key")
        r.i += 1
        while r.s[r.i:r.i + 1] == " ":
            r.i += 1
        if key in out:
            raise r.error(f"duplicate key {key!r}")
        value, quoted = r.scalar(key)
        out[key] = value if quoted else _plain_value(key, value)
        rest_end = r.s.find("\n", r.i)
        rest_end = len(r.s) if rest_end < 0 else rest_end
        if r.s[r.i:rest_end].strip(" \t"):
            raise r.error(f"settings key {key!r}: trailing content "
                          f"{r.s[r.i:rest_end]!r}")
        r.i = rest_end
    return out


# ---------------------------------------------------------------------------
# split files: a mapping of lists of scalars
# ---------------------------------------------------------------------------

def dump_string_lists(mapping: Dict[str, Sequence]) -> str:
    """``yaml.safe_dump(mapping)`` of a mapping of lists of scalars (a
    split file: keys sorted, block style, an empty list as ``[]``)."""
    _check_keys(mapping)
    if not mapping:
        return "{}\n"
    w = _Writer()
    for key in sorted(mapping):
        items = mapping[key]
        if not isinstance(items, (list, tuple)):
            raise ValueError(f"key {key!r}: {type(items).__name__} values "
                             f"are not supported (lists of scalars only)")
        w.write_indent()
        w.scalar(key, True, split=False)
        w.indicator(":", False)
        if not items:
            w.indicator("[", True)
            w.indicator("]", False)
        for item in items:
            text, is_str = _represent(key, item)
            w.write_indent()
            w.indicator("-", True)
            w.indent = _INDENT
            w.scalar(text, is_str, split=True)
            w.indent = 0
    w.write_indent()
    return "".join(w.out)


class _ListReader(_Reader):
    """A mapping of lists of scalars, in block or flow style."""

    takes = "a split file is a mapping of lists of scalars"

    def peek(self) -> str:
        return self.s[self.i:self.i + 1]

    def skip_spaces(self, newlines: bool = False) -> None:
        while self.peek() in (" ", "\t") or (newlines and self.peek() == "\n"):
            self.i += 1

    def skip_blank_lines(self) -> None:
        """To the start of the next line that holds more than spaces or a
        comment (or to the end)."""
        while self.i < len(self.s):
            end = self.s.find("\n", self.i)
            end = len(self.s) if end < 0 else end
            line = self.s[self.i:end].strip(" \t")
            if line and not line.startswith("#"):
                return
            self.i = min(end + 1, len(self.s))

    def end_of_line(self) -> None:
        self.skip_spaces()
        if self.peek() == "#":
            while self.peek() not in ("", "\n"):
                self.i += 1
        if self.peek() not in ("", "\n"):
            raise self.error(f"trailing content {self.peek()!r}")

    def item(self, key: str, flow: bool, indent: int = 0):
        """One list item: quoted, or plain (in block style with its
        more-indented continuation lines folded in), read as
        ``yaml.safe_load`` reads it."""
        ch = self.peek()
        if ch == "'":
            return self.single_quoted()
        if ch == '"':
            return self.double_quoted()
        if ch in "[]{}&*!|>%@`" or (not flow and ch == "-"
                                    and self.s[self.i + 1:self.i + 2]
                                    in (" ", "\n", "")):
            raise self.error(f"key {key!r}: nested content in a list")
        stop = re.compile(r"[,\[\]{}\n]| #" if flow else r"\n| #")
        m = stop.search(self.s, self.i)
        end = len(self.s) if m is None else m.start()
        lines, self.i = [self.s[self.i:end].strip(" \t")], end
        cont = "\n" + " " * (indent + 1)
        while not flow and self.s.startswith(cont, self.i):
            end = self.s.find("\n", self.i + 1)
            end = len(self.s) if end < 0 else end
            line = self.s[self.i + 1:end].strip(" \t")
            if not line or line.startswith("#") or " #" in line:
                break
            lines.append(line)
            self.i = end
        return _plain_value(key, _fold(lines))

    def flow_sequence(self, key: str) -> list:
        self.i += 1
        items: list = []
        while True:
            self.skip_spaces(newlines=True)
            if self.peek() == "]":
                self.i += 1
                return items
            items.append(self.item(key, flow=True))
            self.skip_spaces(newlines=True)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.error(f"key {key!r}: expected ',' or ']'")

    def block_sequence(self, key: str) -> list:
        items: list = []
        indent = None
        while True:
            self.skip_blank_lines()
            start = self.i
            n = len(self.s[start:]) - len(self.s[start:].lstrip(" "))
            if not (self.s.startswith("-", start + n) and self.s[
                    start + n + 1:start + n + 2] in (" ", "\n", "")):
                if indent is None:
                    raise self.error(f"key {key!r}: expected a list")
                return items
            if indent is None:
                indent = n
            elif n != indent:
                raise self.error(f"key {key!r}: list items at different "
                                 f"indents")
            self.i = start + n + 1
            self.skip_spaces()
            if self.peek() in ("", "\n", "#"):
                items.append(None)
            else:
                items.append(self.item(key, flow=False, indent=indent))
            self.end_of_line()

    def key(self) -> str:
        key, quoted = self.scalar(None)
        if not quoted:
            key = key.rstrip(" \t")
            if _resolve(key) != _STR:
                raise self.error(f"non-string key {key!r}")
        self.skip_spaces()
        if self.peek() != ":":
            raise self.error("expected ':' after the key")
        self.i += 1
        self.skip_spaces()
        return key

    def flow_mapping(self) -> Dict[str, list]:
        self.i += 1
        out: Dict[str, list] = {}
        while True:
            self.skip_spaces(newlines=True)
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.key()
            if key in out:
                raise self.error(f"duplicate key {key!r}")
            self.skip_spaces(newlines=True)
            if self.peek() != "[":
                raise self.error(f"key {key!r}: expected a list")
            out[key] = self.flow_sequence(key)
            self.skip_spaces(newlines=True)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error("expected ',' or '}'")


def parse_string_lists(text: str, where: str = "split file"
                       ) -> Dict[str, list]:
    """Read a mapping of lists of scalars, block style (what
    ``dump_string_lists`` and ``yaml.safe_dump`` write) or flow style
    (``{training: [a, b], test: []}``, ``training: [a, b]``). Items read
    as ``yaml.safe_load`` reads them (``- 1000`` is an int). Anything
    else raises ``ValueError`` naming ``where``."""
    r = _ListReader(text, where)
    r.skip_blank_lines()
    if r.peek() == "{":
        out = r.flow_mapping()
        r.end_of_line()
        r.skip_blank_lines()
        if r.i < len(r.s):
            raise r.error("content after the mapping")
        return out
    out: Dict[str, list] = {}
    while True:
        r.skip_blank_lines()
        if r.i >= len(r.s):
            return out
        if r.peek() in (" ", "\t", "-"):
            raise r.error("expected a key at the start of the line")
        key = r.key()
        if key in out:
            raise r.error(f"duplicate key {key!r}")
        if r.peek() == "[":
            out[key] = r.flow_sequence(key)
            r.end_of_line()
        else:
            r.end_of_line()
            out[key] = r.block_sequence(key)


def load_string_lists(fname: str) -> Dict[str, list]:
    with open(fname, "r") as fp:
        return parse_string_lists(fp.read(), fname)


def save_string_lists(mapping: Dict[str, Sequence], fname: str) -> None:
    text = dump_string_lists(mapping)
    with open(fname, "w") as fp:
        fp.write(text)


# ---------------------------------------------------------------------------
# model registries: a mapping of names to mappings of scalars
# ---------------------------------------------------------------------------

class _RegistryReader(_ListReader):
    """A mapping of names to block (``name:`` then indented ``key:
    value`` lines) or flow (``name: {key: value, ...}``) mappings of
    scalars; a name whose value is a scalar reads as that scalar."""

    takes = ("a model registry is a mapping of names to mappings of "
             "scalars")

    def value(self, key: str, flow: bool, indent: int = 0):
        """The scalar after ``key:`` (None when nothing follows)."""
        self.skip_spaces()
        if self.peek() in ("", "\n", "#") or (flow and self.peek() in ",}"):
            return None
        if self.peek() in "[{":
            raise self.error(f"key {key!r}: nested collections are not "
                             f"supported")
        start = self.i
        value = self.item(key, flow=flow, indent=indent)
        # a plain value's continuation line may not hold a mapping key
        if not flow and re.search(r"\n[^\n]*:(?= |\n|$)",
                                  self.s[start:self.i]):
            raise self.error(f"key {key!r}: a mapping inside a value")
        return value

    def block_entry(self, name: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        indent = None
        while True:
            self.skip_blank_lines()
            start = self.i
            n = len(self.s[start:]) - len(self.s[start:].lstrip(" "))
            if n == 0 or self.s[start + n:start + n + 1] in ("", "\n"):
                return out
            if indent is None:
                indent = n
            elif n != indent:
                raise self.error(f"entry {name!r}: keys at different "
                                 f"indents")
            self.i = start + n
            if self.s.startswith(("- ", "-\n"), self.i):
                raise self.error(f"entry {name!r}: a list, not a mapping")
            key = self.key()
            if key in out:
                raise self.error(f"duplicate key {key!r}")
            out[key] = self.value(key, flow=False, indent=indent)
            self.end_of_line()

    def flow_entry(self, name: str) -> Dict[str, Any]:
        self.i += 1
        out: Dict[str, Any] = {}
        while True:
            self.skip_spaces(newlines=True)
            if self.peek() == "}":
                self.i += 1
                return out
            key = self.key()
            if key in out:
                raise self.error(f"duplicate key {key!r}")
            out[key] = self.value(key, flow=True)
            self.skip_spaces(newlines=True)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error(f"entry {name!r}: expected ',' or '}}'")


def parse_model_registry(text: str, where: str = "model registry"
                         ) -> Dict[str, Any]:
    """Read a model registry (``evaluate/model_registry.py``) as
    ``yaml.safe_load`` reads it: names (in file order) → mappings of
    scalars, block or flow style; an empty file is ``{}``. Nested
    collections, sequences and other YAML raise ``ValueError`` naming
    ``where``."""
    r = _RegistryReader(text, where)
    r.skip_blank_lines()
    out: Dict[str, Any] = {}
    if r.s[r.i:].rstrip() in ("{}", "null", "~", ""):
        return out
    while True:
        r.skip_blank_lines()
        if r.i >= len(r.s):
            return out
        if r.peek() in (" ", "\t", "-", "{", "["):
            raise r.error("expected a name at the start of the line")
        name = r.key()
        if name in out:
            raise r.error(f"duplicate key {name!r}")
        if r.peek() == "{":
            out[name] = r.flow_entry(name)
            r.end_of_line()
        elif r.peek() in ("", "\n", "#"):
            r.end_of_line()
            entry = r.block_entry(name)
            out[name] = entry if entry else None
        else:
            out[name] = r.value(name, flow=False)
            r.end_of_line()


def load_model_registry(fname: str) -> Dict[str, Any]:
    with open(fname, "r") as fp:
        return parse_model_registry(fp.read(), fname)


# ---------------------------------------------------------------------------
# experiment settings
# ---------------------------------------------------------------------------

#: rehydration defaults of an experiment's settings (the JAX package's
#: ``apply_setting_defaults``): use_sigmoid / use_batchnorm default False
#: on purpose, as the reference's model layer falls back when the keys
#: are missing; a post-merge settings.yaml always carries them
SETTING_DEFAULTS = {
    "use_sigmoid": False,
    "use_batchnorm": False,
    "n_res_block": None,
    "colors": 1,
    "use_laploss": False,
    "use_percept_loss": False,
    "image_mix_loss_func": None,
    "use_extra_latent_loss": False,
    "use_loss_annealing": False,
    "get_masks": False,
    "ex_loss_weight1": 0.001,
    "lamb_reg_acai": 0.5,
    "vae_beta": 0.0,
    "lamb": 1.0,
    "ae_class": "VanillaACAI",
    "slice_selection": "adjacent_plus",
    "momentum": 0.9,
    "weight_decay": 0.0,
    "epoch_threshold": 100,
    "lr_warmup_steps": 0,
    "compute_dtype": "float32",
    "nclasses": 4,
    "ema_decay": 0.0,
    "stem_pad_parity": False,
}


def apply_setting_defaults(args: Dict[str, Any]) -> Dict[str, Any]:
    """Fill the keys an older experiment's settings may lack."""
    for k, v in SETTING_DEFAULTS.items():
        args.setdefault(k, v)
    return args


def save_experiment_settings(args: Dict[str, Any], fname: str) -> None:
    text = dump_settings(dict(args))
    os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)
    with open(fname, "w") as fp:
        fp.write(text)


def load_settings(fname: str) -> Dict[str, Any]:
    with open(fname, "r") as fp:
        text = fp.read()
    args = parse_settings(text, fname)
    if not args:
        raise ValueError(f"{fname}: empty settings.yaml (expected a "
                         f"mapping)")
    return apply_setting_defaults(args)
