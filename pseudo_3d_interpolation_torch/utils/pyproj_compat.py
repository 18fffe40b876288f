"""Drop-in pyproj-compatible facade over the analytic CRS engine.

Counterpart of ``pseudo_3d_interpolation_tpu/utils/pyproj_compat.py``, a
host copy over :mod:`pseudo_3d_interpolation_torch.utils.crs` (numpy only).
The reference's coordinate step is written against pyproj
(reproject_segy.py:13-14, 128-143: ``pyproj.crs.CRS(spec)``,
``pyproj.transformer.Transformer.from_crs(src, dst, always_xy=True)``,
``.transform(x, y, errcheck=True)``, ``CRS.is_geographic/is_projected/
to_epsg``). This module reproduces exactly that surface on top of the
same WKT1/WKT2/proj-string/EPSG parser and projection families the
`p3d-torch reproject` step uses, so pyproj-based code runs unchanged:

    from pseudo_3d_interpolation_torch.utils import pyproj_compat
    pyproj_compat.install()          # registers sys.modules['pyproj']
    import pyproj                    # -> this module
    ...
    pyproj_compat.uninstall()        # removes the alias again

Coordinate order follows pyproj's ``always_xy=True`` convention
(lon, lat for geographic CRSs), which is the only mode the reference
uses; ``from_crs(..., always_xy=False)`` raises rather than silently
transposing axes.
"""

from __future__ import annotations

import sys
import types

import numpy as np

from . import crs as _crs


class CRS:
    """pyproj.crs.CRS equivalent: wraps a :func:`utils.crs.parse_crs` spec."""

    def __init__(self, spec):
        if isinstance(spec, CRS):
            spec = spec.spec
        self.spec = spec
        self._proj = _crs.parse_crs(spec)

    @property
    def is_geographic(self) -> bool:
        return self._proj is _crs.GEOGRAPHIC

    @property
    def is_projected(self) -> bool:
        return not self.is_geographic

    def to_epsg(self):
        """Best-effort EPSG code: numeric specs and 'EPSG:xxxx' strings
        round-trip; parsed WKT/proj projections return None (pyproj's
        behavior for CRSs it cannot identify)."""
        spec = self.spec
        if isinstance(spec, (int, np.integer)):
            return int(spec)
        if isinstance(spec, str):
            s = spec.strip()
            if s.isdigit():
                return int(s)
            if s.upper().startswith("EPSG:") and s[5:].strip().isdigit():
                return int(s[5:])
        return None

    def __eq__(self, other):
        if isinstance(other, CRS):
            return self.spec == other.spec
        return NotImplemented

    def __hash__(self):
        return hash(str(self.spec))

    def __repr__(self):
        return f"CRS({self.spec!r})"


class Transformer:
    """pyproj.transformer.Transformer equivalent (always_xy only)."""

    def __init__(self, src: CRS, dst: CRS):
        self._src = src
        self._dst = dst

    @classmethod
    def from_crs(cls, crs_from, crs_to, always_xy: bool = False,
                 **_kwargs) -> "Transformer":
        if not always_xy:
            raise NotImplementedError(
                "only always_xy=True (lon, lat order) is supported")
        return cls(CRS(crs_from), CRS(crs_to))

    def transform(self, xx, yy, errcheck: bool = False, **_kwargs):
        x, y = _crs.transform_any(np.asarray(xx, np.float64),
                                  np.asarray(yy, np.float64),
                                  self._src._proj, self._dst._proj)
        if errcheck and (np.any(~np.isfinite(x)) or np.any(~np.isfinite(y))):
            raise RuntimeError("coordinate transform produced non-finite "
                               "values")
        return x, y


# pyproj exposes both spellings the reference mixes: the top-level names
# and the submodule paths (pyproj.crs.CRS / pyproj.transformer.Transformer)
crs = types.SimpleNamespace(CRS=CRS)
transformer = types.SimpleNamespace(Transformer=Transformer)


def install(force: bool = False) -> types.ModuleType:
    """Register this module as ``sys.modules['pyproj']``. Refuses to
    shadow a real pyproj installation unless ``force``."""
    existing = sys.modules.get("pyproj")
    if existing is not None and not force:
        if getattr(existing, "__p3d_shim__", False):
            return existing
        raise RuntimeError("a real pyproj module is already imported; "
                           "pass force=True to shadow it")
    mod = sys.modules[__name__]
    mod.__p3d_shim__ = True
    sys.modules["pyproj"] = mod
    return mod


def uninstall() -> None:
    """Remove the ``pyproj`` alias if it points at this module."""
    if getattr(sys.modules.get("pyproj"), "__p3d_shim__", False):
        del sys.modules["pyproj"]
