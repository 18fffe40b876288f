"""FFT: the 2-D DFT of the slice; one threshold per slice."""

from __future__ import annotations

import torch

from ... import work
from ..pocs import Transforms, exponential_schedule, fixed_p_min

KEYS = {"shape": (), "program": ()}


class Basis:
    """The 2-D DFT; one threshold per slice."""

    def __init__(self, h: int, w: int, tr: Transforms, device):
        self.tr = tr

    def decay(self, z: torch.Tensor, config: dict) -> torch.Tensor:
        mag = self.tr.fft2(z).abs()
        amax = mag.amax(dim=(-2, -1))
        p_min = fixed_p_min(config)
        if p_min is None:
            size = mag.shape[-2] * mag.shape[-1]
            tau_min = 0.01 * torch.sqrt((mag * mag).sum(dim=(-2, -1)) / size)
        else:
            tau_min = p_min * amax
        return exponential_schedule(config["p_max"] * amax, tau_min,
                                    config["niter"])

    def shrink(self, x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        c = self.tr.fft2(x)
        c = torch.where(c.abs() < tau[:, None, None], 0, c)
        return self.tr.ifft2(c)


def forward_flops(h: int, w: int) -> float:
    """Every line each way."""
    return work.fft2_flops(h, w)


def window_bytes(h: int, w: int) -> int:
    """No table."""
    return 0
