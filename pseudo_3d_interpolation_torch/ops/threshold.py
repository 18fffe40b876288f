"""Magnitude threshold operators (soft / hard / non-negative garrote).

Counterpart of ``pseudo_3d_interpolation_tpu/ops/threshold.py``: same
semantics (PyWavelets-style), the threshold broadcasts against the input,
complex inputs are shrunk by magnitude with their phase kept. The
``*-percentile`` forms read the threshold as a percentile of ``|x|`` over
each slice's trailing two axes, interpolated linearly as
``jnp.percentile`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from .cplx import Cplx

THRESHOLD_KINDS = ("soft", "hard", "garrote", "soft-percentile",
                   "hard-percentile", "garrote-percentile")


def _is_zero(substitute) -> bool:
    return isinstance(substitute, (int, float)) and substitute == 0


def _fill(substitute, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(substitute, dtype=like.dtype, device=like.device)


def soft(x, value, substitute=0.0):
    """Soft threshold: shrink magnitudes by ``value``, zero below it."""
    mag = torch.abs(x)
    denom = torch.where(mag == 0, torch.ones_like(mag), mag)
    out = x * torch.clamp(1.0 - value / denom, min=0.0)
    if _is_zero(substitute):
        return out
    return torch.where(mag < value, _fill(substitute, out), out)


def hard(x, value, substitute=0.0):
    """Hard threshold: keep values with ``|x| >= value``, substitute the rest."""
    return torch.where(torch.abs(x) < value, _fill(substitute, x), x)


def garrote(x, value, substitute=0.0):
    """Non-negative garrote: ``x * max(1 - value^2 / |x|^2, 0)``."""
    mag2 = torch.abs(x) ** 2
    denom = torch.where(mag2 == 0, torch.ones_like(mag2), mag2)
    out = x * torch.clamp(1.0 - (value * value) / denom, min=0.0)
    if _is_zero(substitute):
        return out
    return torch.where(mag2 < value * value, _fill(substitute, out), out)


def soft_pair(z: Cplx, value) -> Cplx:
    """Soft threshold of a ``Cplx`` pair by magnitude, phase-preserving."""
    mag = z.abs()
    denom = torch.where(mag == 0, torch.ones_like(mag), mag)
    shrink = torch.clamp(1.0 - value / denom, min=0.0)
    return Cplx(z.re * shrink, z.im * shrink)


def hard_pair(z: Cplx, value) -> Cplx:
    """Hard threshold of a ``Cplx`` pair: zero where ``|z| < value``."""
    keep = (z.abs2() >= value * value).to(z.re.dtype)
    return Cplx(z.re * keep, z.im * keep)


def garrote_pair(z: Cplx, value) -> Cplx:
    """Non-negative garrote threshold of a ``Cplx`` pair by magnitude."""
    mag2 = z.abs2()
    denom = torch.where(mag2 == 0, torch.ones_like(mag2), mag2)
    shrink = torch.clamp(1.0 - (value * value) / denom, min=0.0)
    return Cplx(z.re * shrink, z.im * shrink)


def _percentile_from_mag(mag: torch.Tensor, perc) -> torch.Tensor:
    """Per-slice percentile of magnitudes ``(..., H, W)``: shape
    ``mag.shape[:-2] + (1, 1)``.

    ``perc`` is a scalar or a per-slice array broadcastable to the batch
    shape (trailing broadcast axes, as a ``(..., 1, 1)`` threshold has, are
    stripped). The two neighbours of the rank ``q/100·(n−1)`` of each
    slice (from one sort of it, or on the host, when every slice asks for
    the same rank, from one selection) are interpolated, all in float32 as
    ``jnp.percentile`` computes it: the indices are clamped to the slice,
    the weights are not (so a q outside [0, 100] gives an end value), and
    a slice holding a NaN
    gives NaN. ``torch.quantile`` is not used: it refuses inputs above 2**24
    elements and takes one q for all rows."""
    batch_shape = mag.shape[:-2]
    flat = mag.reshape(-1, mag.shape[-2] * mag.shape[-1])
    n = flat.shape[-1]
    q = torch.as_tensor(perc, dtype=torch.float32, device=mag.device)
    while q.dim() > len(batch_shape):  # strip trailing broadcast axes
        q = q[..., 0]
    # n − 1 rounded as float32 (as JAX computes it), held as a Python
    # float: a device scalar would cost a host-to-device copy a call
    top = float(np.float32(n) - np.float32(1))
    q = torch.broadcast_to(q, batch_shape).reshape(-1, 1)
    # a true division on every device: on a CUDA tensor, dividing by a
    # Python number multiplies by its rounded reciprocal instead
    q = q / torch.full_like(q, 100.0) * top
    low, high = torch.floor(q), torch.ceil(q)
    high_weight = q - low
    low_weight = 1 - high_weight
    low = low.clamp(0, top).to(torch.int64).clamp(max=n - 1)
    high = high.clamp(0, top).to(torch.int64).clamp(max=n - 1)
    flat = flat.float()
    if (flat.device.type == "cpu" and flat.shape[0]
            and bool((low == low[0]).all())):
        # one rank for every row (the solver's percentiles are one value
        # per iteration): the host's selection beats its sort several
        # times over. The rank above low is low's value while equal values
        # last, else the least value above it.
        v_low = torch.kthvalue(flat, int(low[0]) + 1, dim=-1,
                               keepdim=True).values
        above = torch.where(flat > v_low, flat,
                            torch.full_like(flat, float("inf")))
        v_high = torch.where(
            (flat <= v_low).sum(dim=-1, keepdim=True) > high, v_low,
            above.amin(dim=-1, keepdim=True))
    else:
        ordered = torch.sort(flat, dim=-1).values
        v_low = torch.gather(ordered, -1, low)
        v_high = torch.gather(ordered, -1, high)
    t = v_low * low_weight + v_high * high_weight
    t = torch.where(torch.isnan(flat).any(dim=-1, keepdim=True),
                    torch.full_like(t, float("nan")), t)
    return t.reshape(batch_shape + (1, 1))


def _unknown(kind: str) -> ValueError:
    return ValueError(
        f"Unknown threshold kind {kind!r}; choose one of {THRESHOLD_KINDS}")


def threshold_pair(z: Cplx, value, kind: str = "soft") -> Cplx:
    """Dispatch a magnitude threshold on a ``Cplx`` pair by name."""
    base = kind.removesuffix("-percentile")
    if base != kind:
        value = _percentile_from_mag(z.abs(), value)
    if base == "soft":
        return soft_pair(z, value)
    if base == "hard":
        return hard_pair(z, value)
    if base in ("garrote", "garotte"):
        return garrote_pair(z, value)
    raise _unknown(kind)


def threshold(x, value, substitute=0.0, kind: str = "soft"):
    """Dispatch a threshold operator on a real or complex tensor by name;
    for the ``*-percentile`` kinds ``value`` is a percentile of ``|x|``
    per slice (the trailing two axes)."""
    base = kind.removesuffix("-percentile")
    if base != kind:
        value = _percentile_from_mag(torch.abs(x), value)
    if base == "soft":
        return soft(x, value, substitute)
    if base == "hard":
        return hard(x, value, substitute)
    if base in ("garrote", "garotte"):
        return garrote(x, value, substitute)
    raise _unknown(kind)
