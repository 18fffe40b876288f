"""Sparse-transform protocol for the POCS solver: the FFT basis.

Counterpart of ``pseudo_3d_interpolation_tpu/models/transforms.py``. A
transform is a small frozen object with ``forward``, ``inverse``, ``decay``
and ``threshold`` over ``Cplx`` pairs, batch first. Only the FFT basis is
ported; the other kinds raise :class:`NotImplementedError` naming their
ROADMAP queue item.
"""

from __future__ import annotations

import dataclasses

from ..ops import decay as decay_ops
from ..ops import dft
from ..ops import threshold as threshold_ops
from ..ops.cplx import Cplx

_PRECISIONS = ("highest", "high", "default")


def _resolve_precision(p) -> str:
    """'highest' | 'high' | 'default' (any case) or None -> canonical name.

    On the TPU these named the matmul passes (f32, bf16x3, bf16). Here the
    solve kernel computes 'high' and 'highest' in full fp32 and refuses
    'default'; their Hopper mapping is an open ROADMAP item."""
    if p is None:
        return "highest"
    name = str(p).lower()
    if name not in _PRECISIONS:
        raise ValueError(f"unknown precision {p!r}; choose one of "
                         f"{_PRECISIONS}")
    return name


@dataclasses.dataclass(frozen=True)
class FFTTransform:
    """2D Fourier basis (reference FFT kind)."""

    precision: str = "highest"
    kind: str = "FFT"

    def forward(self, z: Cplx) -> Cplx:
        return dft.fft2(z)

    def inverse(self, coeffs: Cplx) -> Cplx:
        return dft.ifft2(coeffs)

    def decay(self, coeffs: Cplx, model, niter, p_max, p_min, decay_kind):
        return decay_ops.threshold_decay(
            coeffs.abs(), model, niter, p_max=p_max, p_min=p_min,
            kind=decay_kind)

    def threshold(self, coeffs: Cplx, t, op: str) -> Cplx:
        # t: (*batch,) per-slice threshold -> broadcast over the slice
        return threshold_ops.threshold_pair(coeffs, t[..., None, None],
                                            kind=op)


_REGISTRY = {}


def register_transform(name: str, factory) -> None:
    """Register a transform factory under an (upper-case) kind name."""
    _REGISTRY[name.upper()] = factory


def _not_ported(kind: str, queue: str):
    def factory(**kw):
        raise NotImplementedError(
            f"transform {kind!r} is not ported yet ({queue})")
    return factory


register_transform("FFT", lambda precision="highest", **kw:
                   FFTTransform(precision=precision))
register_transform("DCT", _not_ported("DCT", "ROADMAP queue 1 #5, queue 2 #6"))
register_transform("WAVELET", _not_ported("WAVELET",
                                          "ROADMAP queue 1 #13, queue 2 #7"))
register_transform("SHEARLET", _not_ported(
    "SHEARLET", "ROADMAP queue 1 #11, queue 2 #3-#5 and #8"))
register_transform("CURVELET", _not_ported(
    "CURVELET", "ROADMAP queue 1 #12, queue 2 #3-#5"))

# the union of constructor options across all bases of the JAX package: a
# config may carry options for another basis than the selected one, but a
# key outside this set is a typo and fails loudly
TRANSFORM_OPTION_KEYS = ("wavelet", "level", "n_scales", "precision",
                         "box_precision",
                         "nbscales", "nbangles_coarse", "allcurvelets",
                         "decimated")


def get_transform(kind: str, **kwargs):
    """Build a transform by reference kind name."""
    kind = kind.upper()
    if kind not in _REGISTRY:
        raise ValueError(
            f"Unsupported transform {kind!r}; available: {sorted(_REGISTRY)}")
    unknown = set(kwargs) - set(TRANSFORM_OPTION_KEYS)
    if unknown:
        raise TypeError(
            f"unknown transform option(s) for {kind}: {sorted(unknown)}; "
            f"recognized: {sorted(TRANSFORM_OPTION_KEYS)}")
    return _REGISTRY[kind](**kwargs)
