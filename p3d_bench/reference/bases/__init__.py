"""The bases the reference knows, one module a basis, found by the
configuration's ``basis``: ``bases/<basis lowercased>.py``. Each gives
four parts:

- ``Basis(h, w, tr, device, **keys)``: the reference basis of an h x w
  slice in the ``Transforms`` ``tr``, with ``decay(z, config)`` (the
  thresholds of every iteration) and ``shrink(x, tau)`` (forward
  transform, hard threshold, inverse);
- ``forward_flops(h, w, **keys)``: the frozen work count of one forward
  transform of one slice (``work.py`` says how work is counted);
- ``window_bytes(h, w, **keys)``: the basis's own tables, read once;
- ``KEYS``: ``{"shape": (...), "program": (...)}``, the transform keys
  the basis takes. Those under ``shape`` shape the basis: the reference
  and the work count receive them. Those under ``program`` only choose
  the program's arithmetic, and the reference ignores them.

A configuration may carry its transform's keys in a ``"transform"``
object (absent: none); stage 2 receives them all. A key the basis's
module does not declare is refused, as is a basis with no module or a
module that lacks a part.
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent
PARTS = ("Basis", "forward_flops", "window_bytes", "KEYS")


class BasisError(ValueError):
    """A basis the reference has no module for, a module that lacks a
    part, or a transform key its module does not declare."""


def _rel(path: Path) -> str:
    return str(path.relative_to(HERE.parents[2]))


def module(basis: str):
    """The module of ``basis``, with its four parts."""
    path = HERE / f"{basis.lower()}.py"
    if not basis.isidentifier() or not path.is_file():
        raise BasisError(f"the reference has no {basis!r} basis: no module "
                         f"{_rel(path)}")
    mod = importlib.import_module(f"{__name__}.{basis.lower()}")
    missing = [p for p in PARTS if not hasattr(mod, p)]
    if missing:
        raise BasisError(f"basis module {_rel(path)} lacks "
                         f"{', '.join(missing)}")
    return mod


def shape_keys(config: dict) -> dict:
    """The keys of ``config["transform"]`` that shape its basis; a key
    that the basis's module does not declare is refused."""
    keys = config.get("transform", {})
    if not isinstance(keys, dict):
        raise BasisError(f"\"transform\" is {keys!r}, not an object")
    declared = module(config["basis"]).KEYS
    unknown = sorted(set(keys) - set(declared["shape"])
                     - set(declared["program"]))
    if unknown:
        raise BasisError(f"basis {config['basis']} takes no transform key "
                         f"{', '.join(map(repr, unknown))} (its module "
                         f"declares {declared})")
    return {k: v for k, v in keys.items() if k in declared["shape"]}
