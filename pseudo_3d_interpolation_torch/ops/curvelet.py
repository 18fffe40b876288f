"""Fast discrete curvelet frame (FDCT wrapping geometry) for the CURVELET
basis.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/curvelet.py`` (its
undecimated part): Meyer-windowed curvelet wedges with CurveLab's wrapping
frequency geometry (dyadic concentric-square coronae, the parabolic angle
law: ``nbangles_coarse`` wedges at the coarsest angular ring, doubling
every other ring, an isotropic finest ring unless ``allcurvelets``),
normalised pointwise into an exactly tight frame. The windows and the
support-cropped plan are numpy, built exactly as the JAX package builds
them (bit-equal), and share the shearlet plan format, so the planned
transforms, the streamed apply and the subband kernels of
``ops/shearlet.py`` serve both bases.

Subband order: 0 = lowpass, then per angular ring (coarse -> fine) its
wedges (horizontal double-cone interior, vertical interior, the two
diagonal seam wedges), then the finest isotropic ring (when
``allcurvelets=False``).

Not ported yet: the decimated (wrapped) coefficient representation (JAX
ops/curvelet.py:209-332), whose solve runs the JAX package's plain XLA
scan (ROADMAP), and the split plans (``split_threshold``).
"""

from __future__ import annotations

import functools

import numpy as np

from .shearlet import _meyer_aux, _psi2_hat, build_plan, symmetrize_and_tighten


def _ring_window(rho, flat_top: bool = False):
    """Meyer corona in the pseudo-radius: support [1/2, 2], peak at 1.
    ``flat_top=True`` stays 1 beyond the peak, so the finest ring covers
    the grid corner up to Nyquist."""
    rho = np.abs(rho)
    out = np.zeros_like(rho)
    m1 = (rho >= 0.5) & (rho <= 1.0)
    out[m1] = np.sin(np.pi / 2.0 * _meyer_aux(2.0 * rho[m1] - 1.0))
    if flat_top:
        out[rho > 1.0] = 1.0
    else:
        m2 = (rho > 1.0) & (rho <= 2.0)
        out[m2] = np.cos(np.pi / 2.0 * _meyer_aux(rho[m2] - 1.0))
    return out


def _lowpass_window(rho):
    """Isotropic lowpass: 1 for rho <= 1/2, Meyer rolloff to 0 at rho = 1."""
    rho = np.abs(rho)
    out = np.zeros_like(rho)
    out[rho <= 0.5] = 1.0
    m = (rho > 0.5) & (rho <= 1.0)
    out[m] = np.cos(np.pi / 2.0 * _meyer_aux(2.0 * rho[m] - 1.0))
    return out


def default_nbscales(h: int, w: int) -> int:
    """CurveLab's default scale count: ceil(log2(min(shape)) - 3), >= 2."""
    return max(int(np.ceil(np.log2(min(h, w)) - 3)), 2)


def ring_angles(nbscales: int, nbangles_coarse: int = 16,
                allcurvelets: bool = False) -> list:
    """Wedge count (over the full circle) per ring; 0 = isotropic ring.
    ``nbscales`` counts the lowpass and ``nbscales - 1`` coronae."""
    if nbangles_coarse % 4:
        raise ValueError("nbangles_coarse must be a multiple of 4")
    r = nbscales - 1
    n_ang = r if allcurvelets else r - 1
    out = [nbangles_coarse * 2 ** (s // 2) for s in range(n_ang)]
    if not allcurvelets:
        out.append(0)
    return out


def n_subbands(nbscales: int, nbangles_coarse: int = 16,
               allcurvelets: bool = False) -> int:
    """1 lowpass + n/2 symmetrised wedge pairs per angular ring (+ the
    finest ring)."""
    return 1 + sum(max(n // 2, 1)
                   for n in ring_angles(nbscales, nbangles_coarse,
                                        allcurvelets))


@functools.lru_cache(maxsize=8)
def curvelet_spectra(h: int, w: int, nbscales: int | None = None,
                     nbangles_coarse: int = 16,
                     allcurvelets: bool = False) -> np.ndarray:
    """The (L, H, W) curvelet windows (numpy float32, fft layout), real,
    symmetric under ω -> −ω, normalised so that Σ_l Psi_l² == 1."""
    if nbscales is None:
        nbscales = default_nbscales(h, w)
    if nbscales < 2:
        raise ValueError("nbscales must be >= 2")
    w1 = np.fft.ifftshift(np.arange(-(h // 2), (h + 1) // 2))[:, None].astype(
        np.float64)
    w2 = np.fft.ifftshift(np.arange(-(w // 2), (w + 1) // 2))[None, :].astype(
        np.float64)
    W1 = np.broadcast_to(w1, (h, w))
    W2 = np.broadcast_to(w2, (h, w))
    e = np.maximum(np.abs(W1), np.abs(W2))  # concentric-square radius
    emax = float(e.max())

    with np.errstate(divide="ignore", invalid="ignore"):
        t_h = np.where(W1 != 0, W2 / W1, 0.0)  # horizontal double cone
        t_v = np.where(W2 != 0, W1 / W2, 0.0)  # vertical double cone
    cone_h = np.abs(W2) <= np.abs(W1)
    cone_v = ~cone_h

    r = nbscales - 1  # coronae
    c = [emax * 2.0 ** (s - r + 1) for s in range(r)]
    angles = ring_angles(nbscales, nbangles_coarse, allcurvelets)

    psis = [_lowpass_window(e / c[0])]

    def _wedges(radial, n_circle):
        """The n_circle/2 symmetrised wedges of one ring: per double cone
        n-1 interior wedges centred on the axes and diagonals, then the two
        diagonal seam wedges glued across the cone boundary."""
        n = n_circle // 4
        delta = 2.0 / n
        out = []
        for t_own, own in ((t_h, cone_h), (t_v, cone_v)):
            for i in range(1, n):
                ti = -1.0 + delta * i
                out.append(np.where(own, radial * _psi2_hat((t_own - ti)
                                                            / delta), 0.0))
        for sgn in (1.0, -1.0):
            out.append(np.where(cone_h,
                                radial * _psi2_hat((t_h - sgn) / delta),
                                radial * _psi2_hat((t_v - sgn) / delta)))
        return out

    for s in range(r):
        radial = _ring_window(e / c[s], flat_top=s == r - 1)
        if angles[s] == 0:
            psis.append(radial)  # isotropic (wavelet) ring
        else:
            psis.extend(_wedges(radial, angles[s]))

    psi = np.stack(psis).astype(np.float64)
    expect = n_subbands(nbscales, nbangles_coarse, allcurvelets)
    if psi.shape[0] != expect:
        raise RuntimeError(f"built {psi.shape[0]} subbands, expected "
                           f"{expect}")
    return symmetrize_and_tighten(psi,
                                  f"curvelet ({h},{w}) {nbscales} scales")


@functools.lru_cache(maxsize=8)
def curvelet_plan(h: int, w: int, nbscales: int | None = None,
                  nbangles_coarse: int = 16, allcurvelets: bool = False,
                  split_threshold: int | None = None):
    """Support-cropped plan (host, cached): ring s vanishes outside
    |ω| <= 2·c_s, the lowpass shares ring 0's box and the flat-topped
    finest ring is full size. The plan format is the shearlet one, so
    ``ops.shearlet``'s planned transforms and apply take it."""
    if split_threshold is not None:
        raise NotImplementedError(
            "split plans (split_threshold) are not ported yet (ROADMAP); "
            "the JAX package builds none by default")
    if nbscales is None:
        nbscales = default_nbscales(h, w)
    psi = curvelet_spectra(h, w, nbscales, nbangles_coarse, allcurvelets)
    r = nbscales - 1
    emax = max(h, w) / 2.0
    angles = ring_angles(nbscales, nbangles_coarse, allcurvelets)
    subbands = [max(n // 2, 1) for n in angles]
    counts = [1 + subbands[0]] + subbands[1:]
    bounds = [int(np.ceil(2.0 * emax * 2.0 ** (s - r + 1))) for s in range(r)]
    bounds[-1] = None  # the finest ring is flat-topped to the corner
    return build_plan(psi, counts, bounds)
