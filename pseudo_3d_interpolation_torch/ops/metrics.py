"""Reconstruction-quality metrics: SNR, PSNR, Immerkær noise level.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/metrics.py``: batched,
reductions over the axes given by ``axis``; numpy inputs go to ``device``
(default the first CUDA card), tensors stay where they are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import as_tensor
from ..utils.rescale import rescale


def _is_complex(v) -> bool:
    return (v.is_complex() if isinstance(v, torch.Tensor)
            else np.iscomplexobj(v))


def _pair(x, y, device):
    """Both inputs as tensors on one device: complex64 when either is
    complex, float32 otherwise."""
    dtype = (torch.complex64 if _is_complex(x) or _is_complex(y)
             else torch.float32)
    x = as_tensor(x, device, dtype=dtype)
    return x, as_tensor(y, device=x.device if device is None else device,
                        dtype=dtype)


def _sum(v, axis):
    return v.sum() if axis is None else v.sum(dim=axis)


def snr(x, y, axis=None, device=None):
    """Signal-to-noise ratio (dB) of reconstruction ``y`` against truth
    ``x``: ``10 log10(sum|x|² / sum|x - y|²)``; ``inf`` where they match
    exactly."""
    x, y = _pair(x, y, device)
    num = _sum(x.abs() ** 2, axis)
    den = _sum((x - y).abs() ** 2, axis)
    return torch.where(den == 0, math.inf,
                       10.0 * torch.log10(num / torch.where(den == 0, 1.0,
                                                            den)))


def psnr(x, y, max_pixel=1.0, axis=None, device=None):
    """Peak signal-to-noise ratio (dB), the reference's formula
    ``10 log10(max_pixel / sqrt(MSE))``; ``max_pixel=None`` uses
    ``max(x)``."""
    x, y = _pair(x, y, device)
    d2 = (x - y).abs() ** 2
    mse = d2.mean() if axis is None else d2.mean(dim=axis)
    xr = x.real if x.is_complex() else x
    if max_pixel is None:
        peak = xr.amax() if axis is None else xr.amax(dim=axis)
    else:
        peak = max_pixel
    return torch.where(mse == 0, math.inf,
                       10.0 * torch.log10(peak / torch.sqrt(
                           torch.where(mse == 0, 1.0, mse))))


def immerkaer_noise_level(img, device=None):
    """Immerkær (1996) fast noise estimate of a 2D image: rescaled to
    [0, 255], convolved ('full') with the Laplacian difference mask, the
    absolute response averaged. Shape ``(H, W)`` -> scalar.

    The 3x3 convolution is nine shifted products of the zero-padded image
    (the mask is symmetric, so convolution and correlation agree), exact
    in float32 whatever the card's TF32 settings."""
    img = rescale(as_tensor(img, device), 0.0, 255.0)
    h, w = img.shape
    mask = ((1.0, -2.0, 1.0), (-2.0, 4.0, -2.0), (1.0, -2.0, 1.0))
    padded = torch.nn.functional.pad(img, (2, 2, 2, 2))
    resp = torch.zeros((h + 2, w + 2), dtype=img.dtype, device=img.device)
    for i in range(3):
        for j in range(3):
            resp = resp + mask[i][j] * padded[i: i + h + 2, j: j + w + 2]
    sigma = resp.abs().sum()
    return sigma * math.sqrt(0.5 * math.pi) / (6.0 * (w - 2) * (h - 2))
