"""Carry the JAX package's solver state across to this package.

The system has no learned weights: what defines a solve is the solver
configuration and the plan constants: the DFT and DCT matrices (built
bit-equal in ``ops/dft.py``), the wavelet filters and their periodized DWT
matrices (bit-equal in ``ops/wavelet.py``), and the shearlet and curvelet windows
and their support-cropped plans (bit-equal in ``ops/shearlet.py`` and
``ops/curvelet.py``). Each is
rebuilt here from the transform's kind and options, so a transform carries
across by those alone. These helpers turn the JAX
package's configuration and plan, as plain Python and numpy values
(``dataclasses.asdict(jax_config)``, a transform's kind and options, a
plan's arrays), into this package's objects, so both run the same solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .models.pocs import TPU_ONLY_FIELDS, POCSConfig
from .models.transforms import get_transform
from .ops.shearlet import Plan, _ScaleGroup


def _plain(value):
    """numpy scalars -> Python scalars; everything else unchanged."""
    return value.item() if isinstance(value, np.generic) else value


def config_from_reference(d: dict) -> POCSConfig:
    """``dataclasses.asdict`` of the JAX package's ``POCSConfig`` -> this
    package's :class:`POCSConfig`, dropping only :data:`TPU_ONLY_FIELDS`
    (``pad_to_tile`` is carried: the cube drivers honour it). A field
    this package does not know raises ``TypeError``."""
    fields = {f.name for f in dataclasses.fields(POCSConfig)}
    unknown = set(d) - fields - set(TPU_ONLY_FIELDS)
    if unknown:
        raise TypeError(f"POCSConfig has no field(s) {sorted(unknown)}")
    return POCSConfig(**{k: _plain(v) for k, v in d.items() if k in fields})


def transform_from_reference(kind: str, kwargs: dict | None = None):
    """A transform kind and its options, as the JAX package's
    ``get_transform`` takes them (FFT, DCT, WAVELET with ``wavelet`` and
    ``level``, SHEARLET with ``n_scales`` and ``box_precision``, CURVELET
    with ``nbscales``, ``nbangles_coarse``, ``allcurvelets`` and
    ``box_precision``; ``precision`` for each) -> this package's
    transform."""
    return get_transform(kind, **{k: _plain(v)
                                  for k, v in (kwargs or {}).items()})


def plan_from_reference(groups, perm) -> Plan:
    """A JAX shearlet or curvelet plan's arrays -> this package's
    :class:`Plan` (the two bases share the plan format).

    ``groups``: one ``(idx_h, idx_w, psi)`` per plan group, as numpy
    (``(g.idx_h, g.idx_w, g.psi) for g in jax_plan``; the indices are None
    for a full-size group); ``perm``: ``jax_plan.perm``. The arrays are
    copied, so the plan owns them."""
    out = []
    for idx_h, idx_w, psi in groups:
        if (idx_h is None) != (idx_w is None):
            raise ValueError("a group's idx_h and idx_w must both be None "
                             "(full size) or both be given")
        psi = np.array(psi, np.float32)
        if idx_h is not None:
            idx_h = np.array(idx_h, np.int32)
            idx_w = np.array(idx_w, np.int32)
            if psi.shape[1:] != (len(idx_h), len(idx_w)):
                raise ValueError(f"psi {psi.shape} does not match the box "
                                 f"({len(idx_h)}, {len(idx_w)})")
        out.append(_ScaleGroup(idx_h, idx_w, psi))
    return Plan(out, np.array(perm, np.int64))
