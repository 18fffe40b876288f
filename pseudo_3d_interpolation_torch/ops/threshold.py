"""Magnitude threshold operators (soft / hard / non-negative garrote).

Counterpart of ``pseudo_3d_interpolation_tpu/ops/threshold.py``: same
semantics (PyWavelets-style), the threshold broadcasts against the input,
complex inputs are shrunk by magnitude with their phase kept. The
percentile forms are not ported yet (ROADMAP queue 1 #4).
"""

from __future__ import annotations

import torch

from .cplx import Cplx

THRESHOLD_KINDS = ("soft", "hard", "garrote")


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


def _not_ported(kind: str):
    if kind.endswith("-percentile"):
        return NotImplementedError(
            f"threshold {kind!r}: the percentile forms are not ported yet "
            "(ROADMAP queue 1 #4)")
    return ValueError(
        f"Unknown threshold kind {kind!r}; choose one of {THRESHOLD_KINDS}")


def threshold_pair(z: Cplx, value, kind: str = "soft") -> Cplx:
    """Dispatch a magnitude threshold on a ``Cplx`` pair by name."""
    if kind == "soft":
        return soft_pair(z, value)
    if kind == "hard":
        return hard_pair(z, value)
    if kind in ("garrote", "garotte"):
        return garrote_pair(z, value)
    raise _not_ported(kind)


def threshold(x, value, substitute=0.0, kind: str = "soft"):
    """Dispatch a threshold operator on a real or complex tensor by name."""
    if kind == "soft":
        return soft(x, value, substitute)
    if kind == "hard":
        return hard(x, value, substitute)
    if kind in ("garrote", "garotte"):
        return garrote(x, value, substitute)
    raise _not_ported(kind)
