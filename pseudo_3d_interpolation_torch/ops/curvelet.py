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

The decimated (wrapped) coefficient representation, CurveLab's storage,
is at the end: each band's coefficients live on a small grid of its
frequency support (``decimated_layout``, ``decimated_forward``,
``decimated_inverse``). ``curvelet_plan(split_threshold=...)`` builds the
split plans of ``ops.shearlet.build_plan``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cplx import Cplx
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
    ``ops.shearlet``'s planned transforms and apply take it.
    ``split_threshold`` re-groups large rings into per-wedge exact-support
    groups (``ops.shearlet.build_plan``); off by default."""
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
    return build_plan(psi, counts, bounds, split_threshold)


# ---------------------------------------------------------------------------
# Decimated (wrapped) coefficients: each band's coefficients are the plain
# ifft2 on its own small grid, the rows × cols of its (padded) frequency
# support, frequencies wrapping onto the grid modulo its size:
#
#   forward:  c_l = ifft2_{sr×sc}( X[rows_l × cols_l] · ψ_l )
#   inverse:  X  += scatter_{rows_l × cols_l}( fft2_{sr×sc}(c_l) · ψ_l )
#
# Reconstruction is exact (fft∘ifft is the identity on the small grid and
# Σ_l ψ_l² = 1), and ‖c_l‖² = ‖X·ψ_l‖²/(sr·sc), so the grid size sets
# which coefficients a hard threshold keeps. Box-group bands keep the
# plan's box indices; a full-size group's band is cropped to its nonzero
# rows and columns, each set padded to a multiple of 8 with frequencies
# where ψ is zero (the JAX package's padding: it fixes the grid, and with
# it the function computed), or kept at full size when the crop would
# hold at least half the grid.
# ---------------------------------------------------------------------------


def _pad_index_set(idx: np.ndarray, n: int, mult: int = 8) -> np.ndarray:
    """Extend a frequency index set to a multiple of ``mult`` with indices
    outside the set (ψ is zero there, so coefficients are unchanged)."""
    idx = np.asarray(idx, np.int64)
    need = (-len(idx)) % mult
    if need == 0:
        return idx
    free = np.setdiff1d(np.arange(n, dtype=np.int64), idx,
                        assume_unique=False)
    return np.concatenate([idx, free[:need]])


class DecimatedLayout(list):
    """The per-band wrapped grids, in plan band order: ``(rows, cols,
    psi)`` numpy, ``psi`` the (len(rows), len(cols)) window crop, or
    ``rows``/``cols`` None and ``psi`` (H, W) for a band kept at full
    size. :meth:`bands_on` gives each band's flat gather index and window
    on a device, copied once per device."""

    def __init__(self, bands, w: int):
        super().__init__(bands)
        self.w = w
        self._dev = {}

    def bands_on(self, device) -> list:
        """[(flat index (sr·sc,) int64 or None, psi tensor), ...] on
        ``device``."""
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = [
                (None if rows is None else torch.from_numpy(
                    (rows[:, None] * self.w + cols[None, :]).ravel()
                ).to(device), torch.from_numpy(psi).to(device))
                for rows, cols, psi in self]
        return self._dev[key]


@functools.lru_cache(maxsize=8)
def decimated_layout(h: int, w: int, nbscales: int | None = None,
                     nbangles_coarse: int = 16,
                     allcurvelets: bool = False) -> DecimatedLayout:
    """The wrapped grid of every band of the plan (host, cached), bit-equal
    to the JAX package's ``decimated_layout``."""
    plan = curvelet_plan(h, w, nbscales, nbangles_coarse, allcurvelets)
    layout = []
    for g in plan:
        lg = g.psi.shape[0]
        if g.idx_h is not None:
            for l in range(lg):
                layout.append((np.asarray(g.idx_h, np.int64),
                               np.asarray(g.idx_w, np.int64),
                               np.asarray(g.psi[l], np.float32)))
            continue
        for l in range(lg):
            nz = np.abs(g.psi[l]) > 0
            rows = _pad_index_set(np.nonzero(nz.any(axis=1))[0], h)
            cols = _pad_index_set(np.nonzero(nz.any(axis=0))[0], w)
            if len(rows) * len(cols) * 2 >= h * w:
                layout.append((None, None, np.asarray(g.psi[l], np.float32)))
            else:
                layout.append((rows, cols, np.ascontiguousarray(
                    g.psi[l][np.ix_(rows, cols)], np.float32)))
    return DecimatedLayout(layout, w)


def decimated_coeff_elements(h: int, w: int, nbscales: int | None = None,
                             nbangles_coarse: int = 16,
                             allcurvelets: bool = False) -> tuple[int, int]:
    """(decimated, undecimated) coefficient element counts per slice."""
    lay = decimated_layout(h, w, nbscales, nbangles_coarse, allcurvelets)
    dec = sum((len(r) * len(c)) if r is not None else h * w
              for r, c, _ in lay)
    return dec, len(lay) * h * w


def decimated_forward(z: Cplx, layout: DecimatedLayout) -> list:
    """Wrapped-coefficient forward: ``z`` (..., H, W) pair -> one (...,
    sr_l, sc_l) pair per band, in plan band order."""
    batch, (h, w) = z.shape[:-2], z.shape[-2:]
    zf = torch.fft.fft2(torch.complex(z.re, z.im))
    flat = zf.reshape(-1, h * w)
    outs = []
    for (rows, cols, _), (index, psi) in zip(layout,
                                             layout.bands_on(zf.device)):
        if index is None:
            sub = zf
        else:
            sub = flat.index_select(1, index).reshape(
                batch + (len(rows), len(cols)))
        c = torch.fft.ifft2(sub * psi)
        outs.append(Cplx(c.real.contiguous(), c.imag.contiguous()))
    return outs


def decimated_inverse(coeffs, layout: DecimatedLayout, h: int,
                      w: int) -> Cplx:
    """Inverse of :func:`decimated_forward` -> (..., H, W) pair. Each
    band's spectrum is added at its grid's frequencies (distinct within a
    band, so the sum runs in band order)."""
    batch = coeffs[0].re.shape[:-2]
    acc = torch.zeros(batch + (h, w), dtype=torch.complex64,
                      device=coeffs[0].re.device)
    flat = torch.view_as_real(acc).view(-1, h * w, 2)
    for c, (index, psi) in zip(coeffs, layout.bands_on(acc.device)):
        v = torch.fft.fft2(torch.complex(c.re, c.im)) * psi
        if index is None:
            acc += v
        else:
            flat.index_add_(1, index, torch.view_as_real(v).reshape(
                flat.shape[0], -1, 2))
    out = torch.fft.ifft2(acc)
    return Cplx(out.real.contiguous(), out.imag.contiguous())
