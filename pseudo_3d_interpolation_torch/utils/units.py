"""Depth / two-way-traveltime / sample-index conversions.

Counterpart of ``pseudo_3d_interpolation_tpu/utils/units.py``.
reference: pseudo_3D_interpolation/functions/utils.py:304-400. Pure functions
over numbers or arrays (numpy arrays and torch tensors both work — only
arithmetic ops are used).
"""

from __future__ import annotations

_TIME_UNITS = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}


def _dt_in_seconds(dt, units: str):
    try:
        return dt * _TIME_UNITS[units]
    except KeyError:
        raise ValueError(f"Unsupported time unit {units!r}; choose one of {list(_TIME_UNITS)}")


def depth2twt(depth, v: float = 1500.0):
    """Depth (m) -> TWT (s) for acoustic velocity ``v`` (m/s)."""
    return depth / (v / 2.0)


def twt2depth(twt, v: float = 1500.0, units: str = "s"):
    """TWT (in ``units``) -> depth (m)."""
    return (v / 2.0) * _dt_in_seconds(twt, units) if units != "s" else (v / 2.0) * twt


def twt2samples(twt, dt: float, units: str = "s"):
    """TWT (s) -> fractional sample index, for sampling interval ``dt`` (``units``)."""
    return twt / _dt_in_seconds(dt, units)


def samples2twt(samples, dt: float):
    """Sample count -> TWT in the same unit as ``dt``."""
    return samples * dt


def depth2samples(depth, dt: float, v: float = 1500.0, units: str = "s"):
    """Depth (m) -> fractional sample index."""
    return twt2samples(depth2twt(depth, v=v), dt=dt, units=units)


def samples2depth(samples, dt: float, v: float = 1500.0, units: str = "s"):
    """Sample count -> depth (m)."""
    return twt2depth(samples * _dt_in_seconds(dt, units), v=v)


def euclidean_distance(coords):
    """Distances between consecutive (N, 2) points
    (reference: functions/utils.py:402-406)."""
    import numpy as np

    diff = np.diff(np.asarray(coords, float), axis=0)
    return np.sqrt((diff**2).sum(axis=1))


def convert_twt(twt, unit_in: str, unit_out: str):
    """Convert TWT values between time units (s/ms/us/ns)."""
    for u in (unit_in, unit_out):
        if u not in _TIME_UNITS:
            raise ValueError(f"Unsupported time unit {u!r}; choose one of {list(_TIME_UNITS)}")
    return twt * (_TIME_UNITS[unit_in] / _TIME_UNITS[unit_out])
