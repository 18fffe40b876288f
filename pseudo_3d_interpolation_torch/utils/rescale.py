"""Min/max rescaling.

Counterpart of ``pseudo_3d_interpolation_tpu/utils/rescale.py``. torch has
no ``nanmin``/``nanmax``, so the NaNs are masked by hand.
"""

from __future__ import annotations

import math

import torch

from .device import as_tensor


def nan_range(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of ``a`` over its values that are not NaN; NaN when all
    are (``jnp.nanmin``/``jnp.nanmax``)."""
    nan = torch.isnan(a)
    lo = torch.where(nan, math.inf, a).amin()
    hi = torch.where(nan, -math.inf, a).amax()
    if bool(nan.all()):
        lo = hi = torch.full((), math.nan, dtype=a.dtype, device=a.device)
    return lo, hi


def rescale(a, vmin=0.0, vmax=1.0, amin=None, amax=None, device=None):
    """Linearly rescale ``a`` from its (NaN-aware) range to [vmin, vmax],
    in float32.

    ``amin``/``amax`` override the data range (when the global range is
    known without a full reduction, e.g. one chunk of a cube). Degenerate
    input (amin == amax) is returned unchanged.
    """
    a = as_tensor(a, device)
    if amin is None or amax is None:
        lo, hi = nan_range(a)
    lo = lo if amin is None else torch.as_tensor(amin, dtype=a.dtype,
                                                 device=a.device)
    hi = hi if amax is None else torch.as_tensor(amax, dtype=a.dtype,
                                                 device=a.device)
    same = hi == lo
    scale = (vmax - vmin) / torch.where(same, 1.0, hi - lo)
    return torch.where(same, a, vmin + (a - lo) * scale)
