"""The plain reference of the solve stage: rfft over time, POCS on each
frequency slice, in plain PyTorch.

It follows the published method and nothing of the program under test:
the forward transform ``X(f) = dt * sum_t x[t] exp(-2 pi i f t dt)`` of
each trace (the cube's first sample is at t = 0); per slice the decay of
thresholds from the slice's own coefficients (exponential from
``p_max * max|c|`` down to the adaptive minimum of Zhao et al. 2021), and
FPOCS iterations (Nesterov momentum with O'Donoghue and Candes's adaptive
restart): forward transform, hard threshold, inverse transform,
reinsertion ``x = x_rec * (1 - alpha * mask) + alpha * x_obs``; with
``eps`` > 0 a slice whose cost (Gao et al. 2013) falls below ``eps``
after the third iteration keeps its state from then on. A slice that is
all zero is returned as it is.

The basis is the configuration's ``basis``, found by name in
``reference/bases/`` (one module a basis; ``bases/__init__.py`` says
what each gives).

``precision`` "float64" computes everything in float64. "tf32" is the
control: float32 with the input of every 2-D transform rounded to TF32's
10-bit mantissa, as a tensor-core DFT would take it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import bases

PRECISIONS = ("float64", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """A complex64 or float32 tensor with every float rounded to the
    nearest value with a 10-bit mantissa (ties away from zero)."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real.contiguous()),
                             round_tf32(x.imag.contiguous()))
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Transforms:
    """The 2-D transforms of a precision: float64 as they are, "tf32"
    with the input of each rounded."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.complex = (torch.complex128 if precision == "float64"
                        else torch.complex64)
        self.real = (torch.float64 if precision == "float64"
                     else torch.float32)
        self.rnd = round_tf32 if precision == "tf32" else (lambda x: x)

    def fft2(self, x):
        return torch.fft.fft2(self.rnd(x))

    def ifft2(self, x):
        return torch.fft.ifft2(self.rnd(x))


def time_spectrum(x: torch.Tensor, dt: float, bins) -> torch.Tensor:
    """The spectrum of real traces ``x`` (..., t) at rfft ``bins``, scaled
    by ``dt``, complex128, frequency first: (len(bins), ...)."""
    spec = torch.fft.rfft(x.to(torch.float64), dim=-1)[..., bins] * dt
    return spec.movedim(-1, 0)


def exponential_schedule(tau_max: torch.Tensor, tau_min: torch.Tensor,
                         niter: int) -> torch.Tensor:
    """``tau_max * (tau_min / tau_max) ** (i / (niter - 1))`` for i < niter,
    zero where ``tau_max`` is zero: (niter,) + tau_max.shape."""
    m = torch.arange(niter, dtype=tau_max.dtype, device=tau_max.device)
    m = (m / max(niter - 1, 1)).reshape((niter,) + (1,) * tau_max.dim())
    safe_max = torch.where(tau_max == 0, torch.ones_like(tau_max), tau_max)
    safe_min = torch.where(tau_min == 0,
                           torch.full_like(tau_min, 1e-38), tau_min)
    out = tau_max * torch.exp(torch.log(safe_min / safe_max) * m)
    return torch.where(tau_max == 0, torch.zeros_like(out), out)


def fixed_p_min(config: dict) -> float | None:
    """The configuration's numeric ``p_min``; None where it is
    "adaptive"."""
    p = config["p_min"]
    if isinstance(p, str):
        if p != "adaptive":
            raise ValueError(f"p_min {p!r}")
        return None
    return float(p)


def basis_for(config: dict, h: int, w: int, tr: Transforms, device):
    """The reference basis of ``config["basis"]`` (its module in
    ``bases/``) at h x w, built with the transform keys that shape it."""
    return bases.module(config["basis"]).Basis(h, w, tr, device,
                                               **bases.shape_keys(config))


def fpocs(z: torch.Tensor, mask: torch.Tensor, basis, config: dict
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """FPOCS on a batch of slices ``z`` (B, H, W) complex with the (H, W)
    ``mask``: (the reconstructed slices, the iterations each ran)."""
    if config["thresh_op"] != "hard" or config["version"] != "fast":
        raise ValueError("the reference runs FPOCS with a hard threshold")
    if config["thresh_model"] != "exponential":
        raise ValueError("the reference's decay is exponential")
    alpha, eps, niter = config["alpha"], config["eps"], config["niter"]
    mask = mask.to(basis.tr.real)
    keep = 1.0 - alpha * mask
    decay = basis.decay(z, config)
    b = z.shape[0]

    def absum(x):
        return x.abs().sum(dim=(-2, -1))

    x_prev = x_curr = z
    active = torch.ones(b, dtype=torch.bool, device=z.device)
    n_iter = torch.zeros(b, dtype=torch.int64, device=z.device)
    cost_prev = torch.full((b,), math.inf, dtype=basis.tr.real,
                           device=z.device)
    v = torch.ones(b, dtype=basis.tr.real, device=z.device)
    for i in range(niter):
        v1 = (1.0 + torch.sqrt(1.0 + 4.0 * v * v)) / 2.0
        frac = ((v - 1.0) / (v1 + 1.0))[:, None, None]
        x_in = x_curr + frac * (x_curr - x_prev)
        x_rec = basis.shrink(x_in, decay[i]) * keep + alpha * z
        s = absum(x_rec)
        d = s - absum(x_curr)
        cost = d * d / torch.where(s == 0, torch.ones_like(s), s * s)
        restart = cost > cost_prev
        prev_next = torch.where(restart[:, None, None], x_rec, x_curr)
        v_next = torch.where(restart, torch.ones_like(v1), v1)
        act = active[:, None, None]
        x_prev = torch.where(act, prev_next, x_prev)
        x_curr = torch.where(act, x_rec, x_curr)
        n_iter += active.to(torch.int64)
        cost_prev = torch.where(active, cost, cost_prev)
        v = torch.where(active, v_next, v)
        if eps != 0.0 and i > 2:
            active = active & ~(cost < eps)
    nonzero = (z.abs() ** 2).sum(dim=(-2, -1)) > 0
    out = torch.where(nonzero[:, None, None], x_curr, z)
    return out, torch.where(nonzero, n_iter, torch.zeros_like(n_iter))


def solve_slices(z: torch.Tensor, mask: torch.Tensor, config: dict,
                 precision: str = "float64", block: int = 8,
                 basis=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference solve of frequency slices ``z`` (S, H, W) complex,
    ``block`` slices at a time, in ``precision``: (complex128 slices, the
    iterations each ran)."""
    tr = Transforms(precision)
    h, w = z.shape[-2:]
    if basis is None:
        basis = basis_for(config, h, w, tr, z.device)
    out = torch.empty(z.shape, dtype=torch.complex128, device=z.device)
    iters = torch.empty(z.shape[0], dtype=torch.int64, device=z.device)
    m = mask.to(device=z.device)
    for s0 in range(0, z.shape[0], block):
        zb = z[s0:s0 + block].to(tr.complex)
        rec, iters[s0:s0 + block] = fpocs(zb, m, basis, config)
        out[s0:s0 + block] = rec.to(torch.complex128)
    return out, iters


def snr_db(truth: np.ndarray, estimate: np.ndarray, device="cpu",
           block: int = 32) -> tuple[float, float]:
    """``10 log10(sum a**2 / sum (a - e)**2)`` in float64 of the amplitudes
    (a = truth, e = estimate) and of their magnitudes (a = |truth|,
    e = |estimate|, as the north-star runner compares the bases it solves
    in chunked launches), ``block`` ilines at a time on ``device``."""
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    for r0 in range(0, truth.shape[0], block):
        a = torch.from_numpy(truth[r0:r0 + block]).to(device, torch.float64)
        e = torch.from_numpy(estimate[r0:r0 + block]).to(device,
                                                         torch.float64)
        sums[0] += (a * a).sum()
        sums[1] += ((a - e) ** 2).sum()
        sums[2] += ((a.abs() - e.abs()) ** 2).sum()
    num, d_amp, d_mag = (float(v) for v in sums.cpu())
    return tuple(math.inf if d == 0 else 10.0 * math.log10(num / d)
                 for d in (d_amp, d_mag))
