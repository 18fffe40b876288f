"""POCS solver and its sparse transforms.

Exports the JAX package's ``models`` names but ``pocs``: there the
function of that name hides the ``models.pocs`` module, and here
``from pseudo_3d_interpolation_torch.models import pocs`` stays the
module (``models.pocs.pocs`` is the function)."""

from .pocs import (POCSConfig, POCSResult, apocs, fpocs, pocs_interpolate,
                   pocs_interpolate_numpy)
from .transforms import (CurveletTransform, DCTTransform, FFTTransform,
                         ShearletTransform, WaveletTransform, get_transform)

__all__ = [
    "pocs_interpolate_numpy",
    "FFTTransform",
    "DCTTransform",
    "WaveletTransform",
    "ShearletTransform",
    "CurveletTransform",
    "get_transform",
    "POCSConfig",
    "POCSResult",
    "pocs_interpolate",
    "fpocs",
    "apocs",
]
