"""Trace-header coordinate scaling per the SEG-Y convention.

reference: pseudo_3D_interpolation/functions/header.py:13-210. Coordinates
stored as int32 are scaled by ``SourceGroupScalar`` (negative = divide,
positive = multiply); ``CoordinateUnits`` 2 (arc seconds) divides by
3,600,000 to decimal degrees.

A copy of ``pseudo_3d_interpolation_tpu/io/headers.py``, kept here:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def apply_coordinate_scalar(values, scalar: int):
    """Raw int header coords -> real-world units."""
    values = np.asarray(values, float)
    if scalar < 0:
        return values / abs(scalar)
    if scalar > 0:
        return values * scalar
    return values


def scale_coordinates(segy, coords_bytes=(73, 77)):
    """Read + scale (x, y) from a :class:`SegyFile`.

    Returns (x, y, coordinate_units). Arc-second units convert to decimal
    degrees; DD/DMS raise like the reference (header.py:60-64).
    """
    xb, yb = coords_bytes
    x = segy.header(xb).astype(float)
    y = segy.header(yb).astype(float)
    if x.size == 0:
        # valid-but-empty file (aborted line): empty coordinates, not an
        # IndexError that aborts a whole-directory navigation scan
        return x, y, 1
    units = int(segy.header("CoordinateUnits")[0])
    if units in (0, 1):
        scalar = int(segy.header("SourceGroupScalar")[0])
        x = apply_coordinate_scalar(x, scalar)
        y = apply_coordinate_scalar(y, scalar)
    elif units == 2:
        x = x / 3_600_000.0
        y = y / 3_600_000.0
    else:
        raise NotImplementedError(f"CoordinateUnits={units} conversion not implemented")
    return x, y, units


def unscale_coordinates(x, y, coords_units: int = 1, scale_factor: int = -100):
    """Real-world (x, y) -> int32 header values for writing.

    ``scale_factor`` follows SEG-Y semantics (negative = values were divided
    on read, so multiply here). reference: header.py:68-118.
    """
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if coords_units in (0, 1):
        if scale_factor < 0:
            x = x * abs(scale_factor)
            y = y * abs(scale_factor)
        elif scale_factor > 0:
            x = x / scale_factor
            y = y / scale_factor
    elif coords_units == 2:
        x = x * 3_600_000.0
        y = y * 3_600_000.0
    else:
        raise NotImplementedError(f"CoordinateUnits={coords_units} not implemented")
    xr_, yr_ = np.rint(x), np.rint(y)
    # the header fields are i4 — a value past 2^31 (easy with scalar -1000
    # on UTM northings) or a NaN would silently wrap to garbage navigation
    lim = np.int64(np.iinfo(np.int32).max)
    bad = (~np.isfinite(xr_) | ~np.isfinite(yr_)
           | (np.abs(xr_) > lim) | (np.abs(yr_) > lim))
    if np.any(bad):
        raise ValueError(
            f"{int(np.count_nonzero(bad))} scaled coordinate(s) exceed the "
            f"int32 SEG-Y header range (or are NaN) with scale_factor="
            f"{scale_factor} — use a smaller |scalar|")
    return xr_.astype(np.int32), yr_.astype(np.int32)


def check_coordinate_scalar(scalar):
    """Validate / resolve a coordinate scalar ('auto' picks −100, i.e. cm
    precision — reference header.py:170-210)."""
    if scalar == "auto":
        return -100
    scalar = int(scalar)
    if scalar == 0:
        return 0
    if abs(scalar) not in (1, 10, 100, 1000, 10000):
        raise ValueError(
            "coordinate scalar must be 'auto', 0, or ±10^k (k: 0..4), "
            f"got {scalar}"
        )
    return scalar
