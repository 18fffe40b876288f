"""Sparse-transform protocol for the POCS solver: the FFT, DCT, WAVELET,
SHEARLET and CURVELET bases.

Counterpart of ``pseudo_3d_interpolation_tpu/models/transforms.py``. A
transform is a small frozen object with ``forward``, ``inverse``, ``decay``
and ``threshold`` over ``Cplx`` pairs, batch first (WAVELET's coefficients
and decay are pywt-style lists); the spectral-stack bases (SHEARLET,
CURVELET) add the fused ``apply_threshold`` and ``decay_from_input`` the
solver's directional route uses. The decimated CURVELET
(``decimated=True``, CurveLab's wrapped coefficient storage) has only the
four methods: the solver runs it on its plain scan.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..ops import curvelet as cv
from ..ops import decay as decay_ops
from ..ops import dft
from ..ops import shearlet as sh
from ..ops import threshold as threshold_ops
from ..ops import wavelet as wv
from ..ops.cplx import Cplx
from ..ops.kernels.pocs_solve import PRECISIONS


def _resolve_precision(p) -> str:
    """'highest' | 'high' | 'default' (any case) or None -> canonical name.

    On the TPU these named the matmul passes (f32, bf16x3, bf16). Here all
    three run in full fp32, on every route and device: what the JAX
    package computes on the CPU. A faster Hopper mapping (TF32, 3xTF32)
    is an open ROADMAP item."""
    if p is None:
        return "highest"
    name = str(p).lower()
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {p!r}; choose one of "
                         f"{PRECISIONS}")
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


@dataclasses.dataclass(frozen=True)
class DCTTransform:
    """2D orthonormal DCT basis (reference DCT kind). The DCT is real and
    linear, so re and im transform independently; thresholds act on the
    joint magnitude."""

    precision: str = "highest"
    kind: str = "DCT"

    def forward(self, z: Cplx) -> Cplx:
        return Cplx(dft.dct2_2d(z.re), dft.dct2_2d(z.im))

    def inverse(self, coeffs: Cplx) -> Cplx:
        return Cplx(dft.idct2_2d(coeffs.re), dft.idct2_2d(coeffs.im))

    def decay(self, coeffs: Cplx, model, niter, p_max, p_min, decay_kind):
        return decay_ops.threshold_decay(
            coeffs.abs(), model, niter, p_max=p_max, p_min=p_min,
            kind=decay_kind)

    def threshold(self, coeffs: Cplx, t, op: str) -> Cplx:
        return threshold_ops.threshold_pair(coeffs, t[..., None, None],
                                            kind=op)


@dataclasses.dataclass(frozen=True)
class WaveletTransform:
    """Multilevel periodized 2D DWT basis (reference WAVELET kind,
    ops/wavelet.py). The approximation band is never thresholded, as the
    reference excludes ``coeffs[0]`` (functions/POCS.py:524, 585-609).
    ``with_shape`` binds a slice shape: it resolves the level and records
    the zero-padded target where the slice needs one."""

    wavelet: str = "db4"
    level: int | None = None
    kind: str = "WAVELET"
    crop: tuple | None = None
    target: tuple | None = None
    precision: Any = None

    def with_shape(self, shape):
        """Bind to a slice shape: the level (at most 3, at least 1) and the
        padded target (a 2**level multiple, at least the filter length at
        the last level), as the JAX package's ``with_shape``."""
        h, w = int(shape[-2]), int(shape[-1])
        level = self.level
        if level is None:
            level = min(max(wv.max_level(h, self.wavelet), 1),
                        max(wv.max_level(w, self.wavelet), 1), 3)
        m = 2 ** level
        filt_len = wv.filter_length(self.wavelet)
        # the axis entering the final level is target / 2**(level-1); it
        # must hold the whole filter for the periodized transform
        min_size = -(-(filt_len * 2 ** (level - 1)) // m) * m
        th = max(-(-h // m) * m, min_size)
        tw = max(-(-w // m) * m, min_size)
        if (th, tw) == (h, w):
            return dataclasses.replace(self, level=level, crop=None,
                                       target=None)
        return dataclasses.replace(self, level=level, crop=(h, w),
                                   target=(th, tw))

    def _pad(self, a: torch.Tensor) -> torch.Tensor:
        if self.target is None:
            return a
        th, tw = self.target
        return F.pad(a, (0, tw - a.shape[-1], 0, th - a.shape[-2]))

    def forward(self, z: Cplx):
        re = wv.wavedec2(self._pad(z.re), self.wavelet, self.level)
        im = wv.wavedec2(self._pad(z.im), self.wavelet, self.level)
        out = [Cplx(re[0], im[0])]
        for (rh, rv, rd), (ih, iv, id_) in zip(re[1:], im[1:]):
            out.append((Cplx(rh, ih), Cplx(rv, iv), Cplx(rd, id_)))
        return out

    def inverse(self, coeffs) -> Cplx:
        re = [coeffs[0].re] + [tuple(c.re for c in det)
                               for det in coeffs[1:]]
        im = [coeffs[0].im] + [tuple(c.im for c in det)
                               for det in coeffs[1:]]
        out = Cplx(wv.waverec2(re, self.wavelet),
                   wv.waverec2(im, self.wavelet))
        if self.crop is not None:
            h, w = self.crop
            out = Cplx(out.re[..., :h, :w], out.im[..., :h, :w])
        return out

    def decay(self, coeffs, model, niter, p_max, p_min, decay_kind):
        """``[zero, (cH, cV, cD)_L, ..., (cH, cV, cD)_1]`` schedules, each
        (niter, *batch); the approximation band's is zero (keep all)."""
        if isinstance(p_min, str):
            raise ValueError(
                "p_min='adaptive' is not defined for the WAVELET transform "
                "(reference functions/POCS.py:321-324)")
        approx = coeffs[0].re
        out = [torch.zeros((niter,) + tuple(approx.shape[:-2]),
                           dtype=torch.float32, device=approx.device)]
        for det in coeffs[1:]:
            out.append(tuple(decay_ops.threshold_decay(
                c.abs(), model, niter, p_max=p_max, p_min=p_min,
                kind=decay_kind) for c in det))
        return out

    def threshold(self, coeffs, t, op: str):
        out = [coeffs[0]]  # the approximation passes through (t[0] is zero)
        for det, t_det in zip(coeffs[1:], t[1:]):
            out.append(tuple(
                threshold_ops.threshold_pair(c, tc[..., None, None], kind=op)
                for c, tc in zip(det, t_det)))
        return out


class _SpectralStackMixin:
    """What the spectral-stack bases (SHEARLET, CURVELET) share: the planned
    transforms of their ``_plan`` (one plan format, ops/shearlet.py), one
    threshold per subband, and the streamed POCS surface, the fused
    ``inverse(threshold(forward(z)))`` and the decay schedule from
    per-subband statistics, neither of which materialises the
    (B, L, H, W) coefficient stack. ``box_precision`` (default
    ``precision``) is the precision of the support-cropped box groups."""

    def __post_init__(self):
        _resolve_precision(self.precision)
        if self.box_precision is not None:
            _resolve_precision(self.box_precision)

    def forward(self, z: Cplx) -> Cplx:
        return sh.shearlet_transform_planned(
            z, self._plan(z.shape[-2], z.shape[-1]))

    def inverse(self, coeffs: Cplx) -> Cplx:
        return sh.inverse_shearlet_transform_planned(
            coeffs, self._plan(coeffs.shape[-2], coeffs.shape[-1]))

    def threshold(self, coeffs: Cplx, t, op: str) -> Cplx:
        # t: (..., L) per-subband thresholds
        return threshold_ops.threshold_pair(coeffs, t[..., None, None],
                                            kind=op)

    def apply_threshold(self, z: Cplx, t, op: str) -> Cplx:
        """``inverse(threshold(forward(z), t))`` through
        :func:`ops.shearlet.pocs_subband_apply`; ``t``: (B, L)."""
        return sh.pocs_subband_apply(
            z, self._plan(z.shape[-2], z.shape[-1]), t, op,
            precision=_resolve_precision(self.precision),
            box_precision=_resolve_precision(self.box_precision
                                             or self.precision))

    def _streamed_stats(self, z: Cplx):
        return sh.subband_stats(z, self._plan(z.shape[-2], z.shape[-1]))

    @staticmethod
    def _needs_full_forward(model, decay_kind) -> bool:
        """Whether the decay model needs the coefficients themselves, not
        just their per-subband maximum and energy."""
        return (model == "data-driven" or decay_kind != "values"
                or "inverse" in model)


@dataclasses.dataclass(frozen=True)
class ShearletTransform(_SpectralStackMixin):
    """Cone-adapted Meyer shearlet basis (reference SHEARLET kind via
    FFST); coefficients carry subbands on axis -3, (..., L, H, W)."""

    n_scales: int | None = None
    precision: str = "highest"
    box_precision: str | None = None
    kind: str = "SHEARLET"

    def _plan(self, h, w):
        return sh.shearlet_plan(h, w, self.n_scales)

    def decay(self, coeffs: Cplx, model, niter, p_max, p_min, decay_kind):
        mag = coeffs.abs()  # (..., L, H, W): L batches -> per-subband tau
        tau_min_override = None
        if isinstance(p_min, str) and p_min == "adaptive":
            n_scales = self.n_scales or sh.default_scales(
                coeffs.shape[-2], coeffs.shape[-1])
            # one value per slice, shared by all subbands
            tau_min_override = decay_ops.shearlet_adaptive_tau_min(
                mag, n_scales)[..., None]
            p_min = 1e-3  # placeholder, overridden
        return decay_ops.threshold_decay(
            mag, model, niter, p_max=p_max, p_min=p_min, kind=decay_kind,
            tau_min_override=tau_min_override)

    def decay_from_input(self, z: Cplx, model, niter, p_max, p_min,
                         decay_kind):
        """The decay schedule (niter, B, L) straight from the input slices,
        from the streamed per-subband statistics."""
        if self._needs_full_forward(model, decay_kind):
            return self.decay(self.forward(z), model, niter, p_max, p_min,
                              decay_kind)
        h, w = z.shape[-2], z.shape[-1]
        amax, sumsq = self._streamed_stats(z)
        tau_max = p_max * amax
        if isinstance(p_min, str):
            if p_min != "adaptive":
                raise ValueError(f"unknown p_min {p_min!r}")
            n_scales = self.n_scales or sh.default_scales(h, w)
            norms = torch.sqrt(sumsq / (amax.shape[-1] * h * w))
            tau_min = decay_ops.shearlet_adaptive_tau_min_from_norms(
                norms, n_scales)[..., None]
            tau_min = torch.broadcast_to(tau_min, tau_max.shape)
        else:
            tau_min = p_min * amax
        return decay_ops.schedule(model, niter, tau_max, tau_min)


@dataclasses.dataclass(frozen=True)
class CurveletTransform(_SpectralStackMixin):
    """Fast discrete curvelet frame (reference CURVELET kind, CurveLab's
    wrapping geometry) as an exactly tight undecimated frame
    (ops/curvelet.py); coefficients carry wedges on axis -3, (..., L, H, W),
    with one threshold per wedge."""

    nbscales: int | None = None
    nbangles_coarse: int = 16
    allcurvelets: bool = False
    precision: str = "highest"
    box_precision: str | None = None
    kind: str = "CURVELET"

    def _plan(self, h, w):
        return cv.curvelet_plan(h, w, self.nbscales, self.nbangles_coarse,
                                self.allcurvelets)

    @staticmethod
    def _numeric_p_min(p_min) -> None:
        if isinstance(p_min, str):
            raise ValueError(
                "p_min='adaptive' is shearlet-specific (reference "
                "functions/POCS.py:302-324); use a numeric p_min for "
                "CURVELET")

    def decay(self, coeffs: Cplx, model, niter, p_max, p_min, decay_kind):
        self._numeric_p_min(p_min)
        return decay_ops.threshold_decay(
            coeffs.abs(), model, niter, p_max=p_max, p_min=p_min,
            kind=decay_kind)

    def decay_from_input(self, z: Cplx, model, niter, p_max, p_min,
                         decay_kind):
        """The decay schedule (niter, B, L) from the streamed per-wedge
        maxima; a numeric ``p_min`` only."""
        self._numeric_p_min(p_min)
        if self._needs_full_forward(model, decay_kind):
            return self.decay(self.forward(z), model, niter, p_max, p_min,
                              decay_kind)
        amax, _ = self._streamed_stats(z)
        return decay_ops.schedule(model, niter, p_max * amax, p_min * amax)


@dataclasses.dataclass(frozen=True)
class DecimatedCurveletTransform:
    """The curvelet frame with CurveLab's wrapped coefficient storage
    (``ops/curvelet.py``'s decimated section): each band's coefficients are
    the plain ifft2 on its own support grid, about 2.8x fewer elements
    than the undecimated frame at 512². Select it with ``decimated: true``
    among the transform options. A wrapped per-band threshold is another
    nonlinearity than the full-grid one, so the streamed directional route
    does not apply: the solver takes its plain scan (``xla-scan``)."""

    nbscales: int | None = None
    nbangles_coarse: int = 16
    allcurvelets: bool = False
    precision: str = "highest"
    shape: tuple | None = None  # bound by with_shape (the solver calls it)
    kind: str = "CURVELET"
    decimated: bool = True

    def __post_init__(self):
        _resolve_precision(self.precision)

    def with_shape(self, shape):
        return dataclasses.replace(
            self, shape=(int(shape[-2]), int(shape[-1])))

    def _layout(self, h, w):
        return cv.decimated_layout(h, w, self.nbscales,
                                   self.nbangles_coarse, self.allcurvelets)

    def forward(self, z: Cplx):
        return cv.decimated_forward(
            z, self._layout(z.shape[-2], z.shape[-1]))

    def inverse(self, coeffs) -> Cplx:
        if self.shape is None:
            raise ValueError("DecimatedCurveletTransform.inverse needs the "
                             "slice shape: call with_shape first (the "
                             "solver does)")
        h, w = self.shape
        return cv.decimated_inverse(coeffs, self._layout(h, w), h, w)

    def threshold(self, coeffs, t, op: str):
        # t: (..., L) per-band thresholds in plan band order
        return [threshold_ops.threshold_pair(c, t[..., l, None, None],
                                             kind=op)
                for l, c in enumerate(coeffs)]

    def decay(self, coeffs, model, niter, p_max, p_min, decay_kind):
        """(niter, ..., L) schedules from each band's maximum; a numeric
        ``p_min`` only, and no data-driven model (it needs the whole
        coefficient distribution)."""
        if isinstance(p_min, str):
            raise ValueError(
                "p_min='adaptive' is shearlet-specific (reference "
                "functions/POCS.py:302-324); use a numeric p_min for "
                "CURVELET")
        if model == "data-driven":
            raise ValueError(
                "data-driven decay needs the full coefficient distribution "
                "— unsupported for the decimated curvelet representation; "
                "use the default (undecimated) CURVELET transform")
        mags = torch.stack([c.abs().amax(dim=(-2, -1)) for c in coeffs],
                           dim=-1)
        return decay_ops.threshold_decay(
            mags[..., None, None], model, niter, p_max=p_max, p_min=p_min,
            kind=decay_kind)


_REGISTRY = {}


def register_transform(name: str, factory) -> None:
    """Register a transform factory under an (upper-case) kind name."""
    _REGISTRY[name.upper()] = factory


register_transform("FFT", lambda precision="highest", **kw:
                   FFTTransform(precision=precision))
register_transform("DCT", lambda precision="highest", **kw:
                   DCTTransform(precision=precision))
register_transform(
    "WAVELET",
    lambda wavelet="db4", level=None, precision=None, **kw:
    WaveletTransform(wavelet=wavelet, level=level, precision=precision))
register_transform(
    "SHEARLET",
    lambda n_scales=None, precision="highest", box_precision=None,
    **kw: ShearletTransform(n_scales=n_scales, precision=precision,
                            box_precision=box_precision))


def _curvelet_factory(nbscales=None, nbangles_coarse=16, allcurvelets=False,
                      precision="highest", box_precision=None,
                      decimated=False, **kw):
    if decimated:
        if box_precision is not None:
            raise ValueError(
                "box_precision does not apply to decimated=True: EVERY "
                "band is a wrapped/support-cropped grid there — set "
                "'precision' (uniform) instead")
        return DecimatedCurveletTransform(
            nbscales=nbscales, nbangles_coarse=nbangles_coarse,
            allcurvelets=allcurvelets, precision=precision)
    return CurveletTransform(
        nbscales=nbscales, nbangles_coarse=nbangles_coarse,
        allcurvelets=allcurvelets, precision=precision,
        box_precision=box_precision)


register_transform("CURVELET", _curvelet_factory)

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
