"""Iteration-based threshold decay schedules for POCS.

Counterpart of ``pseudo_3d_interpolation_tpu/ops/decay.py`` (the decay
models of the reference's functions/POCS.py:169-368): linear,
exponential[-q], data-driven (Gao et al. 2013), inverse_proportional[-q]
(Ge et al. 2015) and the adaptive minimum ``p_min='adaptive'`` (Zhao et al.
2021). Coefficients arrive as ``(..., H, W)`` magnitudes; every schedule
returns ``(niter, ...)`` float32. The shearlet helpers are not ported yet
(ROADMAP queue 1 #11).
"""

from __future__ import annotations

import torch


def _parse_q(model: str) -> float:
    """Descent-rate exponent from names like ``exponential-2``; a malformed
    numeric suffix raises rather than silently running q=1."""
    if "-" in model:
        tail = model.rsplit("-", 1)[-1]
        try:
            return float(tail)
        except ValueError:
            if tail.isalpha():  # e.g. 'data-driven', 'inverse-proportional'
                return 1.0
            raise ValueError(
                f"malformed decay-model exponent in {model!r} "
                f"(expected e.g. 'exponential-2')") from None
    return 1.0


def _slice_stats(coeff_abs: torch.Tensor):
    """(max, min, l2norm^2, size) reduced over the trailing two axes."""
    amax = torch.amax(coeff_abs, dim=(-2, -1))
    amin = torch.amin(coeff_abs, dim=(-2, -1))
    norm2 = torch.sum(coeff_abs * coeff_abs, dim=(-2, -1))
    size = coeff_abs.shape[-2] * coeff_abs.shape[-1]
    return amax, amin, norm2, size


def adaptive_tau_min(coeff_abs: torch.Tensor) -> torch.Tensor:
    """Zhao et al. (2021): ``0.01 * sqrt(||C||_F^2 / size)`` per slice."""
    _, _, norm2, size = _slice_stats(coeff_abs)
    return 0.01 * torch.sqrt(norm2 / size)


def tau_bounds(coeff_abs: torch.Tensor, p_max=0.99, p_min=1e-3,
               kind: str = "values"):
    """Per-slice ``(tau_max, tau_min)``: ``kind='values'`` scales the slice
    maximum by p_max/p_min (or takes the adaptive minimum);
    ``kind='factors'`` returns the raw percentages."""
    amax, _, _, _ = _slice_stats(coeff_abs)
    if kind == "factors":
        if isinstance(p_min, str):
            raise ValueError(
                "p_min='adaptive' computes a VALUE-domain minimum and has "
                "no percentile ('factors') meaning — pass a numeric "
                "percentage for percentile threshold operators")
        return (torch.full_like(amax, float(p_max)),
                torch.full_like(amax, float(p_min)))
    if kind != "values":
        raise ValueError("kind must be 'values' or 'factors'")
    tau_max = p_max * amax
    if isinstance(p_min, str):
        if p_min != "adaptive":
            raise ValueError(f"unknown p_min {p_min!r}")
        tau_min = adaptive_tau_min(coeff_abs)
    else:
        tau_min = p_min * amax
    return tau_max, tau_min


def schedule(model: str, niter: int, tau_max, tau_min) -> torch.Tensor:
    """Closed-form decay schedules: linear / exponential[-q];
    ``(niter,) + tau_max.shape``."""
    tau_max = torch.as_tensor(tau_max, dtype=torch.float32)
    tau_min = torch.as_tensor(tau_min, dtype=torch.float32,
                              device=tau_max.device)
    denom = max(niter - 1, 1)
    m = (torch.arange(niter, dtype=torch.float32, device=tau_max.device)
         / denom).reshape((niter,) + (1,) * tau_max.ndim)
    if model == "linear":
        return tau_max - (tau_max - tau_min) * m
    if model.startswith("exponential"):
        q = _parse_q(model)
        # an all-zero slice gives tau_max == tau_min == 0: return a zero
        # schedule instead of log(0/0) NaN
        one = torch.ones_like(tau_max)
        safe_max = torch.where(tau_max == 0, one, tau_max)
        safe_min = torch.where(tau_min == 0,
                               torch.finfo(torch.float32).tiny * one, tau_min)
        c = torch.log(safe_min / safe_max)
        out = tau_max * torch.exp(c * m**q)
        return torch.where(tau_max == 0, torch.zeros_like(out), out)
    raise ValueError(f"No closed-form schedule for model {model!r}")


def inverse_proportional(model: str, niter: int,
                         coeff_abs: torch.Tensor) -> torch.Tensor:
    """Ge et al. (2015): ``tau_i = a / i^q + b``, a and b fixed by the
    per-slice coefficient min/max (ignores p_max/p_min)."""
    q = _parse_q(model)
    amax, amin, _, _ = _slice_stats(coeff_abs)
    nq = float(niter) ** q
    if nq == 1.0:
        return amax[None]
    a = (nq * (amax - amin)) / (nq - 1.0)
    b = (nq * amin - amax) / (nq - 1.0)
    i = torch.arange(1, niter + 1, dtype=torch.float32,
                     device=coeff_abs.device)
    i = i.reshape((niter,) + (1,) * amax.ndim)
    return a / (i**q) + b


def data_driven(niter: int, coeff_abs: torch.Tensor, tau_max,
                tau_min) -> torch.Tensor:
    """Gao et al. (2013): sample the descending coefficient curve restricted
    to the open interval (tau_min, tau_max) at
    ``ceil(i·(Nv-1)/(niter-1))``."""
    batch_shape = coeff_abs.shape[:-2]
    flat = coeff_abs.reshape(-1, coeff_abs.shape[-2] * coeff_abs.shape[-1])
    n = flat.shape[-1]
    tmax = torch.as_tensor(tau_max, dtype=flat.dtype, device=flat.device)
    tmin = torch.as_tensor(tau_min, dtype=flat.dtype, device=flat.device)
    tmax = torch.broadcast_to(tmax, batch_shape).reshape(-1, 1)
    tmin = torch.broadcast_to(tmin, batch_shape).reshape(-1, 1)
    vals_desc = torch.sort(flat, dim=-1, descending=True).values
    valid = (vals_desc > tmin) & (vals_desc < tmax)
    nv = valid.sum(dim=-1, keepdim=True).to(torch.int32)
    i = torch.arange(niter, dtype=torch.float32, device=flat.device)[None]
    rank = torch.ceil(i * (nv - 1) / max(niter - 1, 1)).to(torch.int64)
    rank = torch.minimum(rank.clamp(min=0), torch.clamp(nv - 1, min=0))
    # cum[k] = number of valid entries among vals_desc[:k+1]; the
    # (rank+1)-th valid element sits at the first k with cum[k] >= rank+1
    cum = torch.cumsum(valid.to(torch.int64), dim=-1)
    idx = torch.searchsorted(cum, rank + 1, right=False).clamp(0, n - 1)
    out = torch.gather(vals_desc, -1, idx)  # (B, niter)
    return out.transpose(0, 1).reshape((niter,) + tuple(batch_shape))


def threshold_decay(coeff_abs: torch.Tensor, model: str = "exponential",
                    niter: int = 50, p_max: float = 0.99, p_min=1e-3,
                    kind: str = "values") -> torch.Tensor:
    """Batched equivalent of the reference's ``get_threshold_decay``:
    ``(niter,) + coeff_abs.shape[:-2]`` thresholds."""
    if "inverse" in model and "proportional" in model:
        if kind != "values":
            raise ValueError(
                "inverse_proportional decay requires decay_kind='values'")
        return inverse_proportional(model, niter, coeff_abs)
    tau_max, tau_min = tau_bounds(coeff_abs, p_max=p_max, p_min=p_min,
                                  kind=kind)
    if model == "data-driven":
        if kind != "values":
            raise ValueError("data-driven decay requires kind='values'")
        return data_driven(niter, coeff_abs, tau_max, tau_min)
    return schedule(model, niter, tau_max, tau_min)
