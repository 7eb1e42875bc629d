"""A YAML reader for the subset the port's configs use, with the values
`yaml.safe_load` gives them.

The subset: block mappings by indentation, block lists (`- x`,
`- key: value`, a list as a mapping's value at the same indentation),
flow lists (`[384, 512]`, nested), comments, and plain, single- and
double-quoted scalars typed by the YAML 1.1 rules of PyYAML's safe loader
(null, bool, int with its 0b/0x/octal/sexagesimal forms, float). Anything
else (flow mappings, block scalars, anchors, aliases, tags, documents,
multi-line scalars, timestamps) raises `YamlError` with the file and line.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = {"yes", "true", "on"}
# A plain scalar may not start with these (YAML indicators).
_INDICATORS = set("[]{}#&*!|>'\"%@`,?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YamlError(ValueError):
    pass


def _sexagesimal(text: str, number) -> Any:
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + number(part)
    return sign * value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text.startswith("-") else 1
    body = text.lstrip("+-")
    if body == "0":
        return 0
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body.startswith("0"):
        return sign * int(body, 8)
    if ":" in body:
        return _sexagesimal(text, int)
    return sign * int(body)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text.startswith("-") else 1.0
    body = text.lstrip("+-")
    if body == ".inf":
        return sign * float("inf")
    if body == ".nan":
        return float("nan")
    if ":" in body:
        return _sexagesimal(text, float)
    return sign * float(body)


def resolve_plain(text: str, where: str = "") -> Any:
    """A plain scalar's value under YAML 1.1's implicit types."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _TIMESTAMP.match(text):
        raise YamlError(f"{where}: timestamps are outside the subset: "
                        f"{text!r}")
    return text


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: List[Tuple[int, int, str]] = []  # (line, indent, text)
        for number, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw)
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                raise YamlError(f"{self._where(number)}: tab in indentation")
            if stripped.rstrip() in ("---", "...") or stripped.startswith(
                    ("--- ", "%")):
                raise YamlError(f"{self._where(number)}: documents and "
                                f"directives are outside the subset")
            self.lines.append((number, len(body) - len(stripped),
                               stripped.rstrip()))
        self.pos = 0

    def _where(self, number: int) -> str:
        return f"{self.name}:{number}"

    def peek(self) -> Optional[Tuple[int, int, str]]:
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.block(self.lines[0][1])
        if self.peek() is not None:
            raise YamlError(f"{self._where(self.peek()[0])}: bad indentation")
        return value

    def block(self, indent: int) -> Any:
        if _is_item(self.peek()[2]):
            return self.sequence(indent)
        return self.mapping(indent)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            line = self.peek()
            if line is None or line[1] != indent or not _is_item(line[2]):
                if line is not None and line[1] > indent:
                    raise YamlError(f"{self._where(line[0])}: bad "
                                    f"indentation")
                return out
            number, _, text = line
            rest = text[1:].lstrip(" ")
            self.pos += 1
            if not rest:
                out.append(self.nested(indent))
                continue
            # The item's content opens a block at its own column.
            column = indent + len(text) - len(rest)
            if _is_item(rest) or _split_key(rest) is not None:
                self.pos -= 1
                self.lines[self.pos] = (number, column, rest)
                out.append(self.block(column))
            else:
                out.append(self.value(rest, number))
                self.no_continuation(indent)

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.peek()
            if line is None or line[1] < indent:
                return out
            number, col, text = line
            if col > indent:
                raise YamlError(f"{self._where(number)}: bad indentation")
            if _is_item(text):
                return out
            split = _split_key(text)
            if split is None:
                raise YamlError(f"{self._where(number)}: expected 'key: "
                                f"value', got {text!r}")
            key_text, rest = split
            key = self.value(key_text, number, key=True)
            self.pos += 1
            if rest:
                out[key] = self.value(rest, number)
                self.no_continuation(indent)
                continue
            nxt = self.peek()
            if nxt is not None and nxt[1] == indent and _is_item(nxt[2]):
                out[key] = self.sequence(indent)
            else:
                out[key] = self.nested(indent)

    def nested(self, indent: int) -> Any:
        """The block under a key or item that has no value on its line,
        or null where the next line is not deeper."""
        nxt = self.peek()
        if nxt is None or nxt[1] <= indent:
            return None
        return self.block(nxt[1])

    def no_continuation(self, indent: int) -> None:
        nxt = self.peek()
        if nxt is not None and nxt[1] > indent:
            raise YamlError(f"{self._where(nxt[0])}: multi-line scalars "
                            f"are outside the subset")

    def value(self, text: str, number: int, key: bool = False) -> Any:
        where = self._where(number)
        if text.startswith("["):
            if key:
                raise YamlError(f"{where}: a list as a key is outside the "
                                f"subset")
            value, end = _flow_list(text, 0, where)
            if text[end:].strip():
                raise YamlError(f"{where}: trailing text after a list")
            return value
        return _scalar(text, where, flow=False)


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _split_key(text: str) -> Optional[Tuple[str, str]]:
    """'key: value' -> (key, value) where the line is a mapping entry."""
    if text[:1] in "\"'":
        end = _quoted_end(text, 0)
        if end is not None and text[end:end + 1] == ":" and (
                end + 1 == len(text) or text[end + 1] == " "):
            return text[:end], text[end + 1:].strip()
        return None
    if text[:1] == "[":
        return None
    for i, ch in enumerate(text):
        if ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            return text[:i].rstrip(), text[i + 1:].strip()
    return None


def _quoted_end(text: str, start: int) -> Optional[int]:
    """Index just past the quoted scalar opening at `start`."""
    quote = text[start]
    i = start + 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        if quote == '"' and ch == "\\":
            i += 2
            continue
        if quote == '"' and ch == '"':
            return i + 1
        i += 1
    return None


def _strip_comment(line: str) -> str:
    """The line without its comment: '#' at the start or after a space,
    outside quotes."""
    i = 0
    quote = None
    while i < len(line):
        ch = line[i]
        if quote is None:
            if ch == "#" and (i == 0 or line[i - 1] in " \t"):
                return line[:i]
            if ch in "\"'" and (i == 0 or line[i - 1] in " \t[,-:"):
                quote = ch
        elif quote == "'" and ch == "'":
            if line[i + 1:i + 2] == "'":
                i += 1
            else:
                quote = None
        elif quote == '"' and ch == "\\":
            i += 1
        elif quote == '"' and ch == '"':
            quote = None
        i += 1
    return line


def _unquote(text: str, where: str) -> str:
    quote, body = text[0], text[1:-1]
    if quote == "'":
        return body.replace("''", "'")
    out = []
    i = 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = body[i + 1:i + 2]
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        elif code in _HEX_ESCAPES:
            n = _HEX_ESCAPES[code]
            digits = body[i + 2:i + 2 + n]
            if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                raise YamlError(f"{where}: bad escape in {text!r}")
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            raise YamlError(f"{where}: escape outside the subset in {text!r}")
    return "".join(out)


def _scalar(text: str, where: str, flow: bool) -> Any:
    text = text.strip()
    if text[:1] in "\"'":
        end = _quoted_end(text, 0)
        if end != len(text):
            raise YamlError(f"{where}: text after a quoted scalar: {text!r}")
        return _unquote(text, where)
    if (text[:1] in _INDICATORS or text in ("-", ":")
            or text.startswith(("- ", ": ")) or ": " in text
            or text.endswith(":") or " #" in text):
        raise YamlError(f"{where}: outside the subset: {text!r}")
    if flow and any(c in text for c in ",[]{}"):
        raise YamlError(f"{where}: bad flow scalar {text!r}")
    return resolve_plain(text, where)


def _flow_list(text: str, start: int, where: str) -> Tuple[list, int]:
    """The flow list opening at text[start] == '[' and the index past it."""
    out = []
    i = start + 1
    expect_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i == len(text):
            raise YamlError(f"{where}: unterminated list")
        ch = text[i]
        if ch == "]":
            return out, i + 1
        if ch == ",":
            if expect_item:
                raise YamlError(f"{where}: empty list item")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise YamlError(f"{where}: missing ',' in list")
        if ch == "[":
            item, i = _flow_list(text, i, where)
        elif ch in "\"'":
            end = _quoted_end(text, i)
            if end is None:
                raise YamlError(f"{where}: unterminated string")
            item, i = _unquote(text[i:end], where), end
        elif ch == "{":
            raise YamlError(f"{where}: flow mappings are outside the subset")
        else:
            j = i
            while j < len(text) and text[j] not in ",]":
                j += 1
            item, i = _scalar(text[i:j], where, flow=True), j
        out.append(item)
        expect_item = False


def loads(text: str, name: str = "<string>") -> Any:
    """The document in `text`, as `yaml.safe_load` reads it."""
    return _Reader(text, name).document()


def load_file(path) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read(), str(path))


def parse_scalar(text: str) -> Any:
    """A command-line override's value, as `yaml.safe_load(text)` reads
    it: a scalar, a quoted string or a flow list."""
    text = _strip_comment(text).strip()
    if not text:
        return None
    if text.startswith("["):
        value, end = _flow_list(text, 0, "<override>")
        if text[end:].strip():
            raise YamlError(f"<override>: trailing text after a list: "
                            f"{text!r}")
        return value
    return _scalar(text, "<override>", flow=False)
