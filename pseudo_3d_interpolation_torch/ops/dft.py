"""2D DFT and DCT, and 1-D DFTs along an axis, on ``Cplx`` pairs, and the
dense matrices.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/dft.py``. Conventions
match ``numpy.fft``: forward unnormalized, inverse scaled by ``1/N`` per
axis; the DCT is the orthonormal DCT-II, inverse its transpose. The JAX
package's 1-D transforms are matmul DFTs at HIGHEST precision; here they
are ``torch.fft`` calls, which differ from them at about 1e-6 of the
largest value.

``fft2``/``ifft2`` and ``dct2_2d``/``idct2_2d`` run outside any kernel (the
solver derives its decay schedule from one forward transform), so they are
plain ``torch.fft`` calls and ``torch.matmul`` products. ``dft_matrices``
and ``dct2_matrix`` are built exactly like the JAX package's (float64 on
the host, rounded once to float32), so the plan constants are bit-equal;
the DCT solve's plain version multiplies by ``dct2_matrix``, its kernel
(csrc/pocs_solve.cu) runs a fast DCT on the line FFTs.
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


@functools.lru_cache(maxsize=64)
def dct2_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix ``C`` with ``X = C @ x``; inverse is ``C.T``.

    Computed in float64 on the host, stored float32."""
    k = np.arange(n)[:, None].astype(np.float64)
    t = np.arange(n)[None, :].astype(np.float64)
    c = np.cos(np.pi * (2 * t + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


@functools.lru_cache(maxsize=16)
def dct_on(n: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(C, C.T)`` of :func:`dct2_matrix` on ``device``, both contiguous."""
    c = dct2_matrix(n)
    return (torch.from_numpy(c).to(device),
            torch.from_numpy(np.ascontiguousarray(c.T)).to(device))


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


def dct2_2d(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2D DCT-II over the trailing two axes of a real tensor:
    ``C_h @ x @ C_wᵀ``."""
    ch, _ = dct_on(x.shape[-2], str(x.device))
    _, cwt = dct_on(x.shape[-1], str(x.device))
    return torch.matmul(torch.matmul(ch, x), cwt)


def idct2_2d(x: torch.Tensor) -> torch.Tensor:
    """Inverse orthonormal 2D DCT (DCT-III): ``C_hᵀ @ x @ C_w``."""
    _, cht = dct_on(x.shape[-2], str(x.device))
    cw, _ = dct_on(x.shape[-1], str(x.device))
    return torch.matmul(torch.matmul(cht, x), cw)


def fft1(z: Cplx, axis: int = -1) -> Cplx:
    """1D DFT along ``axis`` of a (re, im) pair (numpy convention)."""
    out = torch.fft.fft(_as_complex(z), dim=axis)
    return Cplx(out.real, out.imag)


def ifft1(z: Cplx, axis: int = -1) -> Cplx:
    """1D inverse DFT along ``axis``; scaled by ``1/N``."""
    out = torch.fft.ifft(_as_complex(z), dim=axis)
    return Cplx(out.real, out.imag)


def rfft1(x: torch.Tensor, axis: int = -1, n: int | None = None) -> Cplx:
    """Real-input 1D DFT along ``axis`` -> the first ``n//2+1`` bins as a
    pair. ``n`` zero-pads (or truncates) the axis first, like
    ``numpy.fft.rfft(x, n)``."""
    out = torch.fft.rfft(x.float(), n=n, dim=axis)
    return Cplx(out.real, out.imag)


def irfft1(z: Cplx, n: int, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`rfft1`: Hermitian bins -> real signal of length
    ``n``. Missing bins count as zeros. The imaginary parts of the DC bin
    and of an even ``n``'s Nyquist bin do not contribute, as in the JAX
    package's weighted contraction (their sines vanish)."""
    re = z.re.float().movedim(axis, -1)
    im = z.im.float().movedim(axis, -1)
    nb = re.shape[-1]
    keep = torch.ones(nb, dtype=im.dtype, device=im.device)
    keep[0] = 0.0
    if n % 2 == 0 and nb == n // 2 + 1:
        keep[-1] = 0.0
    out = torch.fft.irfft(torch.complex(re, im * keep), n=n, dim=-1)
    return out.movedim(-1, axis)
