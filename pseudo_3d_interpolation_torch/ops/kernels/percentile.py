"""Per-band percentile thresholds of the spectral-stack POCS iteration: the
CUDA selection kernel's wrapper and its plain PyTorch version.

:func:`band_percentile` takes one percentile of each segment of keys (one
band's ``|c|`` over a slice's H·W, written by the subband kernels' pass 1:
``subband.subband_keys`` and ``subband.box_keys``) and returns the
thresholds their pass 2 shrinks with. It replaces no TPU kernel: the JAX
package takes this percentile in XLA
(``pseudo_3d_interpolation_tpu/ops/threshold.py :: _percentile_from_mag``)
inside its plain streamed apply. The kernel (``csrc/band_percentile.cu``)
is an exact radix select on the keys' bits, bit-equal to
:func:`band_percentile_plain`, which is ``ops/threshold._percentile_from_mag``
on the same keys. CUDA tensors run the kernel, CPU tensors the plain
version; a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..threshold import _percentile_from_mag
from . import _build
from .pocs_solve import raise_on


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("band_percentile")
    p = ctypes.c_void_p
    lib.p3d_band_percentile.argtypes = [p, p, p, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_float, p]
    lib.p3d_band_percentile.restype = ctypes.c_int
    return lib


def band_percentile_plain(keys: torch.Tensor, q: torch.Tensor
                          ) -> torch.Tensor:
    """``_percentile_from_mag`` of each (H, W) segment of ``keys``
    (..., H, W) at its percentile ``q`` (...): a sort of each segment and
    jnp.percentile's linear rule."""
    return _percentile_from_mag(keys, q)[..., 0, 0]


def band_percentile(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The percentile ``q[i]`` (in percent) of the H·W keys of each segment
    ``keys[i]``: ``keys`` (..., H, W) float32 and ``q`` (...) float32,
    contiguous, on one device. Returns the (...) thresholds, bit-equal on
    the card to :func:`band_percentile_plain` on the same keys (which CPU
    tensors run). The kernel sorts nothing: three radix passes over each
    segment's bits find the two neighbouring ranks."""
    if keys.dim() < 2 or tuple(q.shape) != tuple(keys.shape[:-2]):
        raise ValueError(f"keys must be (..., H, W) and q its (...), got "
                         f"{tuple(keys.shape)} / {tuple(q.shape)}")
    for name, t in (("keys", keys), ("q", q)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != keys.device or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} is on {t.device}; keys and q must "
                             "share one cuda or cpu device")
    n = keys.shape[-2] * keys.shape[-1]
    if n == 0:
        raise ValueError("band_percentile of empty segments")
    if keys.device.type == "cpu":
        return band_percentile_plain(keys, q)
    t = torch.empty_like(q)
    # n − 1 rounded as float32, as the plain version (and JAX) computes it
    top = float(np.float32(n) - np.float32(1))
    with torch.cuda.device(keys.device):
        rc = _lib().p3d_band_percentile(
            keys.data_ptr(), q.data_ptr(), t.data_ptr(), q.numel(), n, top,
            torch.cuda.current_stream(keys.device).cuda_stream)
    raise_on(rc, "band_percentile", tuple(keys.shape))
    band_percentile.launches += 1
    return t


band_percentile.launches = 0
