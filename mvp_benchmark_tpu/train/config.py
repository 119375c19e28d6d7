"""Config system — attribute-access dict compatible with the reference's
munch-based configs (``completion/train.py:196-200``): the YAML *is* the flag
system; keys double as hyperparameters and runtime switches. The shipped
``cfgs/*.yaml`` files use the same keys as the reference so configs port 1:1.

The files are block-style YAML mappings of scalars; ``parse_yaml_mapping``
reads exactly that subset (scalars, comments, quoted strings, nesting by
indentation), so no YAML library is needed.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

# Scalars resolve as in YAML 1.1 (null, booleans, ints, floats), except that
# a float needs no dot before its exponent.
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$|[-+]?[0-9][0-9_]*[eE][-+][0-9]+$")


class Config(dict):
    """dict with attribute access (drop-in for munch.munchify output).

    Missing keys read as None via attribute access — several reference configs
    omit optional keys and the reference code relies on falsy lookups.
    """

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            return None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "Config":
        out = cls()
        for k, v in m.items():
            out[k] = cls.from_mapping(v) if isinstance(v, Mapping) else v
        return out


def _scalar(text: str) -> Any:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    return text


def _nulls(tree: dict) -> dict:
    """A key whose block stayed empty is null, as in YAML."""
    return {k: (_nulls(v) or None) if isinstance(v, dict) else v
            for k, v in tree.items()}


def parse_yaml_mapping(text: str) -> dict:
    """Parse block-style YAML mappings of scalars (``key: value`` lines,
    nested by indentation under a ``key:`` line; no lists or flow style)."""
    root: dict = {}
    # Open blocks: [indent of the key that opened it, mapping, key indent].
    stack = [[-1, root, None]]
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        indent = len(line) - len(line.lstrip(" "))
        while indent <= stack[-1][0]:
            stack.pop()
        block = stack[-1]
        if block[2] is None:
            block[2] = indent
        key, sep, value = stripped.partition(":")
        if not sep or line[:indent].strip(" ") or indent != block[2]:
            raise ValueError(f"line {lineno}: expected 'key: value' in a "
                             f"block mapping, got {line!r}")
        value = value.strip()
        if value[:1] in ("'", '"'):
            end = value.find(value[0], 1)
            if end < 0 or value[end + 1:].strip()[:1] not in ("", "#"):
                raise ValueError(f"line {lineno}: bad quoted value {value!r}")
            value = value[:end + 1]
        else:
            value = re.split(r"\s#", value, maxsplit=1)[0].strip()
        if value == "":
            block[1][key.strip()] = child = {}
            stack.append([indent, child, None])
        else:
            block[1][key.strip()] = _scalar(value)
    return _nulls(root)


def load_config(path: str, **overrides: Any) -> Config:
    with open(path) as f:
        raw = parse_yaml_mapping(f.read())
    cfg = Config.from_mapping(raw)
    for k, v in overrides.items():
        cfg[k] = v
    return cfg


def parse_int_list(value, sep=",") -> list:
    """Parse reference-style comma-separated config strings ('1, 1, 1, 1')."""
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return [int(v) for v in value]
    if isinstance(value, int):
        return [value]
    return [int(v.strip()) for v in str(value).split(sep) if str(v).strip()]


def parse_float_list(value, sep=",") -> list:
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return [float(v) for v in value]
    if isinstance(value, (int, float)):
        return [float(value)]
    return [float(v.strip()) for v in str(value).split(sep) if str(v).strip()]
