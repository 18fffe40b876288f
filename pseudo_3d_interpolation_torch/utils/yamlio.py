"""YAML in and out without a hard dependency on PyYAML.

The card's machine has no PyYAML. Reading a YAML file needs it, so
:func:`load_yaml` imports it there and, where it is absent, raises an
ImportError that names the option that asked for the file. Writing needs
none: :func:`dump_yaml` emits the small documents the command line writes
(the resolved-arguments sidecar) itself, in a form that
``yaml.safe_load`` reads back to the same values.
"""

from __future__ import annotations

import math
import re

# keys written plain: identifiers that YAML 1.1 reads as nothing but a string
_PLAIN_KEY = re.compile(r"[a-z_][a-z0-9_]*\Z")
_RESERVED = {"y", "n", "yes", "no", "on", "off", "true", "false", "null"}


def yaml_module(option: str):
    """The ``yaml`` module; an ImportError naming ``option`` without it."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"{option} reads YAML and needs PyYAML, which is not installed"
        ) from e
    return yaml


def load_yaml(path: str, option: str):
    """``yaml.safe_load`` of the file at ``path`` (read for ``option``)."""
    yaml = yaml_module(option)
    with open(path) as fh:
        return yaml.safe_load(fh)


def _quote(s: str) -> str:
    """A double-quoted YAML scalar: printable ASCII as itself, anything
    else escaped, so no string can read back as a number, a boolean,
    null or a mapping."""
    out = []
    for ch in s:
        c = ord(ch)
        if ch in '"\\':
            out.append("\\" + ch)
        elif 0x20 <= c < 0x7F:
            out.append(ch)
        elif c <= 0xFF:
            out.append(f"\\x{c:02x}")
        elif c <= 0xFFFF:
            out.append(f"\\u{c:04x}")
        else:
            out.append(f"\\U{c:08x}")
    return '"' + "".join(out) + '"'


def _float(v: float) -> str:
    """A float as YAML 1.1 resolves it to a float: PyYAML reads ``1e-05``
    as a string (its float pattern needs a dot), so the mantissa gets one
    (``1.0e-05``), as ``yaml.safe_dump`` writes it."""
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    r = repr(float(v))
    if "." not in r and "e" in r:
        r = r.replace("e", ".0e", 1)
    return r


def _key(k) -> str:
    k = str(k)
    return k if _PLAIN_KEY.match(k) and k not in _RESERVED else _quote(k)


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float(v)
    if isinstance(v, str):
        return _quote(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_key(k)}: {_scalar(x)}"
                               for k, x in v.items()) + "}"
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def dump_yaml(doc: dict) -> str:
    """``doc`` (a mapping of str to None, bool, int, float, str, and lists
    and mappings of those) as a YAML document: the top level in block
    style, one key a line, nested mappings indented, lists in flow
    style."""

    def block(d: dict, indent: str) -> list[str]:
        lines = []
        for k, v in d.items():
            if isinstance(v, dict) and v:
                lines.append(f"{indent}{_key(k)}:")
                lines += block(v, indent + "  ")
            else:
                lines.append(f"{indent}{_key(k)}: {_scalar(v)}")
        return lines

    return "\n".join(block(doc, "")) + "\n"
