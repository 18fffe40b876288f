"""Carry the JAX package's solver state across to this package.

The system has no learned weights: what defines a solve is the solver
configuration and the plan constants (the DFT matrices, built bit-equal in
``ops/dft.py``). These helpers turn the JAX package's configuration, as
plain Python and numpy values (``dataclasses.asdict(jax_config)``, or a
transform's kind and options), into this package's objects, so both run
the same solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .models.pocs import TPU_ONLY_FIELDS, POCSConfig
from .models.transforms import get_transform


def _plain(value):
    """numpy scalars -> Python scalars; everything else unchanged."""
    return value.item() if isinstance(value, np.generic) else value


def config_from_reference(d: dict) -> POCSConfig:
    """``dataclasses.asdict`` of the JAX package's ``POCSConfig`` -> this
    package's :class:`POCSConfig`, dropping only :data:`TPU_ONLY_FIELDS`.
    A field this package does not know raises ``TypeError``."""
    fields = {f.name for f in dataclasses.fields(POCSConfig)}
    unknown = set(d) - fields - set(TPU_ONLY_FIELDS)
    if unknown:
        raise TypeError(f"POCSConfig has no field(s) {sorted(unknown)}")
    return POCSConfig(**{k: _plain(v) for k, v in d.items() if k in fields})


def transform_from_reference(kind: str, kwargs: dict | None = None):
    """A transform kind and its options, as the JAX package's
    ``get_transform`` takes them -> this package's transform."""
    return get_transform(kind, **{k: _plain(v)
                                  for k, v in (kwargs or {}).items()})
