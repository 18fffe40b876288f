"""Feature/capability flags.

Counterpart of ``pseudo_3d_interpolation_tpu/backends.py``.
reference: pseudo_3D_interpolation/functions/backends.py:1-11 (optional-
dependency flags). Here the optional capabilities are the native C++ SEG-Y
core (built with g++ at first use, ``io/native``), the hand-written CUDA
kernels (they need ``nvcc`` and a card), and the device platform itself.
Nothing here builds a CUDA kernel; only torch is imported.
"""

from __future__ import annotations

import functools

TRANSFORMS = ["FFT", "DCT", "WAVELET", "SHEARLET", "CURVELET"]


@functools.lru_cache(maxsize=1)
def native_segy_enabled() -> bool:
    """C++/OpenMP SEG-Y decode core built and loadable (``io/native``; it
    is built here on the first call). When it is not,
    :func:`native_segy_error` says why."""
    from .io import native

    return native.lib() is not None


def native_segy_error() -> str | None:
    """The native core's build or load error, None when it loads."""
    from .io import native

    native.lib()
    return native.build_error()


@functools.lru_cache(maxsize=1)
def kernels_enabled() -> bool:
    """The CUDA kernels can be built and launched: ``nvcc`` is found and a
    CUDA card is present."""
    import torch

    from .ops.kernels._build import KernelBuildError, find_nvcc

    try:
        find_nvcc()
    except KernelBuildError:
        return False
    return torch.cuda.is_available()


@functools.lru_cache(maxsize=1)
def platform() -> str:
    """Where the entry points compute by default: 'cuda' with a card,
    'cpu' without one (the entry points then need ``device='cpu'``),
    'none' if torch cannot tell."""
    import torch

    try:
        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:
        return "none"


def summary() -> dict:
    """All capability flags (for logs / QC reports)."""
    import torch

    n = {"cuda": torch.cuda.device_count() if platform() == "cuda" else 0,
         "cpu": 1, "none": 0}[platform()]
    return {
        "platform": platform(),
        "n_devices": n,
        "native_segy": native_segy_enabled(),
        "native_segy_error": native_segy_error(),
        "kernels": kernels_enabled(),
        "transforms": list(TRANSFORMS),
    }
