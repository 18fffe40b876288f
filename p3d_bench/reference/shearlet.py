"""The shearlet windows of the SHEARLET basis, built with numpy alone.

A frozen copy of the window construction (Meyer-windowed cone-adapted
shearlets, FFST-style, reflect-symmetrised and pointwise normalised into
a tight frame, so that ``sum_l Psi_l**2 == 1``), kept with the benchmark so
that the reference recomputes the basis itself and takes no table from
the program under test. Subband order: 0 = lowpass, then per scale j
(coarse to fine) 2**(j+2) directional subbands.
"""

from __future__ import annotations

import functools

import numpy as np


def _meyer_aux(x):
    """Meyer auxiliary polynomial v(x), v(0)=0, v(1)=1, C^3 smooth."""
    x = np.clip(x, 0.0, 1.0)
    return x**4 * (35.0 - 84.0 * x + 70.0 * x**2 - 20.0 * x**3)


def _b_window(w):
    """Meyer bump b(ω): support 1 <= |ω| <= 4."""
    w = np.abs(w)
    out = np.zeros_like(w)
    m1 = (w >= 1) & (w <= 2)
    out[m1] = np.sin(np.pi / 2.0 * _meyer_aux(w[m1] - 1.0))
    m2 = (w > 2) & (w <= 4)
    out[m2] = np.cos(np.pi / 2.0 * _meyer_aux(w[m2] / 2.0 - 1.0))
    return out


def _psi1_hat(w):
    """Radial window: sqrt(b²(2ω) + b²(ω)), support 1/2 <= |ω| <= 4."""
    return np.sqrt(_b_window(2.0 * w) ** 2 + _b_window(w) ** 2)


def _psi2_hat(w):
    """Angular window: sqrt(v(1+ω)) for ω<=0, sqrt(v(1−ω)) for ω>0;
    support |ω|<=1."""
    out = np.zeros_like(w)
    neg = w <= 0
    out[neg] = np.sqrt(_meyer_aux(1.0 + w[neg]))
    out[~neg] = np.sqrt(_meyer_aux(1.0 - w[~neg]))
    return out


def _phi_hat(w):
    """Scaling window: 1 for |ω|<=1/2, Meyer rolloff to 0 at |ω|=1."""
    w = np.abs(w)
    out = np.zeros_like(w)
    out[w <= 0.5] = 1.0
    m = (w > 0.5) & (w <= 1.0)
    out[m] = np.cos(np.pi / 2.0 * _meyer_aux(2.0 * w[m] - 1.0))
    return out


def n_subbands(n_scales: int) -> int:
    return 1 + sum(2 ** (j + 2) for j in range(n_scales))


def default_scales(h: int, w: int) -> int:
    """Reference scale count: floor(0.5·log2(max(shape)))."""
    s = int(np.floor(0.5 * np.log2(max(h, w))))
    return max(s, 1)


@functools.lru_cache(maxsize=2)
def shearlet_spectra(h: int, w: int, n_scales: int | None = None
                     ) -> np.ndarray:
    """The (L, H, W) shearlet windows (numpy float32, fft layout), real,
    normalised pointwise so that Σ_l Psi_l² == 1 (tight frame)."""
    if n_scales is None:
        n_scales = default_scales(h, w)
    w1 = np.fft.ifftshift(np.arange(-(h // 2), (h + 1) // 2))[:, None].astype(
        np.float64)
    w2 = np.fft.ifftshift(np.arange(-(w // 2), (w + 1) // 2))[None, :].astype(
        np.float64)
    W1 = np.broadcast_to(w1, (h, w))
    W2 = np.broadcast_to(w2, (h, w))

    psis = [_phi_hat(np.maximum(np.abs(W1), np.abs(W2)) / 1.0)]  # lowpass

    with np.errstate(divide="ignore", invalid="ignore"):
        tan_h = np.where(W1 != 0, W2 / W1, 0.0)  # horizontal cone
        tan_v = np.where(W2 != 0, W1 / W2, 0.0)  # vertical cone

    cone_h = np.abs(W2) <= np.abs(W1)
    cone_v = ~cone_h

    for j in range(n_scales):
        a = 4.0 ** (-j)
        if j == n_scales - 1:
            # finest scale: the radial window stays flat out to the grid
            # corner, so the plane is covered up to Nyquist
            r_h = np.where(np.abs(a * W1) >= 1.0, 1.0, _psi1_hat(a * W1))
            r_v = np.where(np.abs(a * W2) >= 1.0, 1.0, _psi1_hat(a * W2))
        else:
            r_h = _psi1_hat(a * W1)
            r_v = _psi1_hat(a * W2)
        for k in range(-(2**j), 2**j + 1):
            ang_h = _psi2_hat((2.0**j) * tan_h + k)
            ang_v = _psi2_hat((2.0**j) * tan_v + k)
            if abs(k) < 2**j:
                # interior shears: separate horizontal and vertical subbands
                psis.append(np.where(cone_h, r_h * ang_h, 0.0))
                psis.append(np.where(cone_v, r_v * ang_v, 0.0))
            elif k == 2**j:
                # seam subbands, glued across the cone boundary
                psis.append(np.where(cone_h, r_h * ang_h, r_v * ang_v))
                psis.append(
                    np.where(cone_h, r_h * _psi2_hat((2.0**j) * tan_h - k),
                             r_v * _psi2_hat((2.0**j) * tan_v - k)))

    psi = np.stack(psis).astype(np.float64)
    if psi.shape[0] != n_subbands(n_scales):
        raise RuntimeError(f"built {psi.shape[0]} subbands, expected "
                           f"{n_subbands(n_scales)}")
    return symmetrize_and_tighten(psi,
                                  f"shearlet ({h},{w}) {n_scales} scales")


def symmetrize_and_tighten(psi: np.ndarray, what: str) -> np.ndarray:
    """Reflect-symmetrise (Psi(ω) == Psi(−ω), as FFST's realCoefficients)
    and pointwise Parseval-normalise a window stack (Σ_l Psi_l² == 1)."""

    def _reflect(p):
        return np.roll(np.roll(p[::-1, ::-1], 1, axis=0), 1, axis=1)

    psi = np.sqrt(0.5 * (psi**2 + np.stack([_reflect(p) for p in psi]) ** 2))

    total = np.sqrt(np.sum(psi**2, axis=0))
    if total.min() <= 1e-6:
        raise RuntimeError(
            f"{what}: window system does not cover the frequency plane "
            f"(min coverage {total.min():.2e})")
    psi = psi / total[None]
    return psi.astype(np.float32)
