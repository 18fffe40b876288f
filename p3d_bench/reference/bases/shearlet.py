"""SHEARLET: the windows of ``reference/shearlet.py`` at the slice's size,
materialised (every band's coefficients ``ifft2(fft2(x) * psi_l)``, the
inverse ``ifft2(sum_l fft2(c_l) * psi_l)``); one threshold per slice and
band. ``n_scales`` shapes the windows (absent: ``default_scales``)."""

from __future__ import annotations

import functools

import torch

from ... import work
from .. import shearlet as sh
from ..pocs import Transforms, exponential_schedule, fixed_p_min

KEYS = {"shape": ("n_scales",), "program": ()}


class Basis:
    """The SHEARLET windows at the slice's size; one threshold per slice
    and band."""

    def __init__(self, h: int, w: int, tr: Transforms, device,
                 n_scales: int | None = None):
        self.tr = tr
        n_scales = scales(h, w, n_scales)
        self.psi = torch.from_numpy(sh.shearlet_spectra(h, w, n_scales)).to(
            device=device, dtype=tr.real)
        scale = [0] + sum(([j + 1] * 2 ** (j + 2) for j in range(n_scales)),
                          [])
        self.log_scale = torch.log10(torch.tensor(
            scale, dtype=tr.real, device=device) + 1.0)

    def coefficients(self, x: torch.Tensor) -> torch.Tensor:
        return self.tr.ifft2(self.tr.fft2(x)[:, None] * self.psi)

    def decay(self, z: torch.Tensor, config: dict) -> torch.Tensor:
        mag = self.coefficients(z).abs()
        amax = mag.amax(dim=(-2, -1))  # (B, L)
        p_min = fixed_p_min(config)
        if p_min is None:
            l, h, w = mag.shape[-3:]
            norms = torch.sqrt((mag * mag).sum(dim=(-2, -1)) / (l * h * w))
            # Zhao et al. (2021): a third of the median of the scale-weighted
            # band norms, one value a slice (L is odd: one middle value)
            med = torch.median(self.log_scale * norms, dim=-1).values
            tau_min = (med / 3.0)[:, None].expand_as(amax)
        else:
            tau_min = p_min * amax
        return exponential_schedule(config["p_max"] * amax, tau_min,
                                    config["niter"])

    def shrink(self, x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        c = self.coefficients(x)
        c = torch.where(c.abs() < tau[:, :, None, None], 0, c)
        return self.tr.ifft2((self.tr.fft2(c) * self.psi).sum(dim=1))


def scales(h: int, w: int, n_scales: int | None) -> int:
    """``n_scales``, or the default scale count at h x w."""
    return sh.default_scales(h, w) if n_scales is None else n_scales


@functools.lru_cache(maxsize=4)
def supports(h: int, w: int, n_scales: int) -> tuple[tuple[int, int], ...]:
    """(rows, columns) on which each window is nonzero."""
    nz = sh.shearlet_spectra(h, w, n_scales) != 0
    return tuple((int(b.any(axis=1).sum()), int(b.any(axis=0).sum()))
                 for b in nz)


def forward_flops(h: int, w: int, n_scales: int | None = None) -> float:
    """The slice's spectrum once each way and each band's support lines
    each way."""
    return work.fft2_flops(h, w) + sum(
        work.support_fft2_flops(h, w, r, c)
        for r, c in supports(h, w, scales(h, w, n_scales)))


def window_bytes(h: int, w: int, n_scales: int | None = None) -> int:
    """The float32 windows."""
    return len(supports(h, w, scales(h, w, n_scales))) * h * w * 4
