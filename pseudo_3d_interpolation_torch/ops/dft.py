"""2D DFT on ``Cplx`` pairs, and the dense DFT matrices the kernels use.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/dft.py``. Conventions
match ``numpy.fft``: forward unnormalized, inverse scaled by ``1/(H·W)``.

``fft2``/``ifft2`` run outside any kernel (the solver derives its decay
schedule from one forward transform), so they are plain ``torch.fft`` calls.
``dft_matrices`` is built exactly like the JAX package's (float64 on the
host, rounded once to float32), so the plan constants are bit-equal; the
CUDA solve (csrc/pocs_solve.cu) multiplies by these matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cplx import Cplx


@functools.lru_cache(maxsize=64)
def dft_matrices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) parts of the forward DFT matrix ``F[j,k] = exp(-2πi jk/n)``.

    Computed in float64 on the host, stored float32. ``F = Fr + i·Fi``.
    """
    jk = np.outer(np.arange(n), np.arange(n)).astype(np.float64)
    ang = -2.0 * np.pi * jk / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _as_complex(z: Cplx) -> torch.Tensor:
    return torch.complex(z.re.float(), z.im.float())


def fft2(z: Cplx) -> Cplx:
    """2D DFT over the trailing two axes of a ``Cplx`` pair."""
    out = torch.fft.fft2(_as_complex(z))
    return Cplx(out.real.contiguous(), out.imag.contiguous())


def ifft2(z: Cplx) -> Cplx:
    """2D inverse DFT over the trailing two axes; scaled by ``1/(H·W)``."""
    out = torch.fft.ifft2(_as_complex(z))
    return Cplx(out.real.contiguous(), out.imag.contiguous())
