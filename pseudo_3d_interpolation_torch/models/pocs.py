"""POCS sparse-inversion solver: the FFT and SHEARLET bases.

Counterpart of ``pseudo_3d_interpolation_tpu/models/pocs.py``. Per
iteration: forward transform -> threshold(decay_i) -> inverse transform ->
reinsertion ``x = x_rec·(1 − α·mask) + α·x_obs``; ``version='fast'`` is
FPOCS (Nesterov with O'Donoghue & Candès adaptive restart). Zero slices
short-circuit like the reference (POCS.py:515-521).

Two routes are ported:
- ``fused-folded[fft]``: the whole FFT-basis solve per batch in the CUDA
  kernel of ``ops/kernels/pocs_solve.py``;
- ``streamed-subband``: the spectral-stack bases (SHEARLET), one Python
  loop over the iterations with the state on the device, each iteration's
  ``inverse(threshold(forward(·)))`` fused in the transform's
  ``apply_threshold`` (the subband kernels on the card). It carries the
  scan's options: regular / fast / adaptive, lane freezing for eps > 0,
  cost history and ``global_early_stop`` (the one host synchronisation per
  iteration, taken only when asked for).
A configuration the JAX package sends elsewhere (the per-iteration kernel
or the XLA scan of the FFT basis: eps ≠ 0, cost history, global early
stop, ``version='adaptive'``, a mask other than the exact 2-D slice mask, a
threshold without a kernel) raises :class:`NotImplementedError` with that
route's reason; nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..ops.cplx import Cplx
from ..ops.kernels.pocs_solve import THRESH_OPS, pocs_solve
from .transforms import FFTTransform, _resolve_precision, get_transform

# fields of the JAX package's POCSConfig that steer the TPU kernels only
# (Pallas on/off, interpret mode, the %128 padding policy); they have no
# meaning here and are dropped wherever a JAX config is read
TPU_ONLY_FIELDS = ("use_pallas", "pallas_interpret", "pad_to_tile")


@dataclasses.dataclass(frozen=True)
class POCSConfig:
    """Solver parameters: the JAX package's POCSConfig without
    :data:`TPU_ONLY_FIELDS` (the kernel is the only route and takes any
    slice shape)."""

    niter: int = 50
    thresh_op: str = "hard"
    thresh_model: str = "exponential"
    eps: float = 0.0
    alpha: float = 1.0
    p_max: float = 0.99
    p_min: Any = 1e-5
    sqrt_decay: bool = False
    decay_kind: str = "values"
    version: str = "regular"  # regular | fast | adaptive
    transform_kind: str = "FFT"
    keep_cost_history: bool = False
    global_early_stop: bool = False


class POCSResult(NamedTuple):
    data: Cplx  # reconstructed slices, same shape as input
    n_iterations: torch.Tensor  # (B,) int32 — effective iterations per slice
    cost: torch.Tensor  # (B,) float32 — final cost per slice
    cost_history: torch.Tensor | None  # (niter, B) when requested


class SolverRoute(NamedTuple):
    """Solver path for a (shape, mask, config, transform) combination.

    ``route`` is ``'fused-folded'`` (the FFT solve kernel),
    ``'streamed-subband'`` (the directional scan over the subband kernels),
    or the name of the JAX package's route that the configuration needs and
    that is not ported yet (``'fused-periter'``, ``'xla-scan'``);
    ``reason`` is then the first failed condition, worded as in the JAX
    package."""

    route: str
    basis: str
    reason: str


def solver_route(shape, mask_shape, config: POCSConfig,
                 transform=None) -> SolverRoute:
    """The solver-path decision for :func:`pocs_interpolate`, in the JAX
    package's gate order."""
    cfg = config
    if transform is None:
        transform = get_transform(cfg.transform_kind)
    op = "garrote" if cfg.thresh_op == "garotte" else cfg.thresh_op
    if hasattr(transform, "apply_threshold"):
        # the subband kernels take any slice shape; the threshold is their
        # one gate
        if op not in THRESH_OPS:
            return SolverRoute(
                "streamed-subband", "", f"threshold {cfg.thresh_op!r} has "
                "no kernel (hard/soft/garrote only)")
        return SolverRoute("streamed-subband", "", "")
    if not isinstance(transform, FFTTransform):
        kind = getattr(transform, "kind", type(transform).__name__)
        return SolverRoute("xla-scan", "",
                           f"transform {kind!r} has no fused kernel")
    batch_ndim = len(shape) - 2
    full_mask = (len(mask_shape) == 2
                 and tuple(mask_shape) == tuple(shape[-2:]))
    if not full_mask:
        return SolverRoute("xla-scan", "fft",
                           "mask must be the exact 2-D (H, W) slice mask")
    if batch_ndim != 1:
        return SolverRoute("xla-scan", "fft", f"batch must be 1-D (got "
                           f"{batch_ndim}-D leading axes)")
    if op not in THRESH_OPS:
        return SolverRoute("xla-scan", "fft", f"threshold {cfg.thresh_op!r} "
                           "has no kernel (hard/soft/garrote only)")
    if cfg.eps != 0.0:
        return SolverRoute("fused-periter", "fft", f"eps={cfg.eps!r} != 0.0 "
                           "(early stopping needs the scan)")
    if cfg.keep_cost_history:
        return SolverRoute("fused-periter", "fft", "keep_cost_history=True")
    if cfg.global_early_stop:
        return SolverRoute("fused-periter", "fft", "global_early_stop=True")
    if cfg.version not in ("regular", "fast"):
        return SolverRoute("fused-periter", "fft", f"version={cfg.version!r} "
                           "(folded kernel supports regular/fast)")
    return SolverRoute("fused-folded", "fft", "")


def describe_route(route: SolverRoute) -> str:
    """One-line description of a :class:`SolverRoute` for driver logs."""
    name = route.route + (f"[{route.basis}]" if route.basis else "")
    if route.reason:
        return f"{name} — not ported: {route.reason}"
    return name


def pocs_interpolate(z: Cplx, mask: torch.Tensor, transform=None,
                     config: POCSConfig = POCSConfig()) -> POCSResult:
    """Run POCS on a batch of slices.

    ``z``: observed data as a ``Cplx`` pair ``(B, H, W)`` (real data has a
    zero imaginary part); ``mask``: ``(H, W)`` sampling mask (1 observed,
    0 missing; the directional route also takes one broadcastable to
    ``z``), on ``z``'s device; ``transform``: defaults to the config's
    ``transform_kind``.
    """
    cfg = config
    if transform is None:
        transform = get_transform(cfg.transform_kind)
    mask = mask.to(device=z.re.device, dtype=torch.float32).contiguous()
    route = solver_route(z.shape, mask.shape, cfg, transform)
    if route.reason or route.route not in ("fused-folded",
                                           "streamed-subband"):
        raise NotImplementedError(describe_route(route))
    if route.route == "streamed-subband":
        return _streamed_scan(z, mask, transform, cfg)

    # one-time decay schedule from the initial forward transform
    decay = transform.decay(transform.forward(z), cfg.thresh_model,
                            cfg.niter, cfg.p_max, cfg.p_min, cfg.decay_kind)
    if cfg.sqrt_decay:
        decay = torch.sqrt(decay)
    result, cost = pocs_solve(
        z, mask, decay.to(torch.float32).contiguous(), alpha=cfg.alpha,
        thresh_op=cfg.thresh_op, version=cfg.version,
        precision=_resolve_precision(transform.precision))

    # zero-input short-circuit (reference POCS.py:515-521)
    nonzero = torch.sum(z.abs2(), dim=(-2, -1)) > 0
    nz = nonzero[:, None, None]
    x_out = Cplx(torch.where(nz, result.re, z.re),
                 torch.where(nz, result.im, z.im))
    n_eff = torch.where(nonzero, cfg.niter, 0).to(torch.int32)
    cost = torch.where(nonzero, cost, torch.zeros_like(cost))
    return POCSResult(x_out, n_eff, cost, None)


def _streamed_scan(z: Cplx, mask: torch.Tensor, transform,
                   cfg: POCSConfig) -> POCSResult:
    """The scan of the directional route (JAX models/pocs.py:392-534) as a
    Python loop; the state stays on the device."""
    if z.re.dim() != 3:
        raise ValueError(f"z must be a (B, H, W) pair, got "
                         f"{tuple(z.re.shape)}")
    op = "garrote" if cfg.thresh_op == "garotte" else cfg.thresh_op
    b = z.re.shape[0]
    device = z.re.device
    alpha = cfg.alpha
    # one-time decay schedule (niter, B, L) from streamed statistics
    decay = transform.decay_from_input(z, cfg.thresh_model, cfg.niter,
                                       cfg.p_max, cfg.p_min, cfg.decay_kind)
    if cfg.sqrt_decay:
        decay = torch.sqrt(decay)
    decay = decay.to(torch.float32)
    keep = 1.0 - alpha * mask  # reinsertion weights
    a_re, a_im = alpha * z.re, alpha * z.im

    def abs_(x: Cplx) -> torch.Tensor:
        return torch.sqrt(x.re * x.re + x.im * x.im)

    x_prev = x_curr = z
    active = torch.ones(b, dtype=torch.bool, device=device)
    n_eff = torch.zeros(b, dtype=torch.int32, device=device)
    # +inf so the restart test cannot fire on the first iteration
    cost_prev = torch.full((b,), float("inf"), device=device)
    v = torch.ones(b, device=device)
    history = []
    early_stop = cfg.global_early_stop and not cfg.keep_cost_history
    for i in range(cfg.niter):
        if early_stop and not bool(active.any()):
            break  # every slice has converged
        v1 = (1.0 + torch.sqrt(1.0 + 4.0 * v * v)) / 2.0
        if cfg.version == "regular":
            x_in = x_curr
        elif cfg.version == "fast":
            # y_k = x_k + frac·(x_k − x_{k−1}), with adaptive restart below
            frac = ((v - 1.0) / (v1 + 1.0))[:, None, None]
            x_in = Cplx(x_curr.re + frac * (x_curr.re - x_prev.re),
                        x_curr.im + frac * (x_curr.im - x_prev.im))
        elif cfg.version == "adaptive":
            # reference POCS.py:572-576
            x_in = Cplx(
                a_re + keep * x_curr.re
                + (1 - alpha) * (z.re - mask * x_curr.re),
                a_im + keep * x_curr.im
                + (1 - alpha) * (z.im - mask * x_curr.im))
        else:
            raise ValueError(f"unknown POCS version {cfg.version!r}")
        rec = transform.apply_threshold(x_in, decay[i], op)
        x_rec = Cplx(rec.re * keep + a_re, rec.im * keep + a_im)

        # cost (Gao et al. 2013): (Σ(|x_new| − |x_curr|))² / (Σ|x_new|)²
        mag_rec = abs_(x_rec)
        d = torch.sum(mag_rec - abs_(x_curr), dim=(-2, -1))
        s = torch.sum(mag_rec, dim=(-2, -1))
        cost = (d * d) / torch.where(s == 0, torch.ones_like(s), s * s)

        if cfg.version == "fast":
            # O'Donoghue & Candès (2015): a cost increase kills the momentum
            restart = cost > cost_prev
            rs = restart[:, None, None]
            prev_cand = Cplx(torch.where(rs, x_rec.re, x_curr.re),
                             torch.where(rs, x_rec.im, x_curr.im))
            v_next = torch.where(restart, torch.ones_like(v1), v1)
        else:
            prev_cand, v_next = x_curr, v1

        # converged lanes keep their state
        act = active[:, None, None]
        x_prev = Cplx(torch.where(act, prev_cand.re, x_prev.re),
                      torch.where(act, prev_cand.im, x_prev.im))
        x_curr = Cplx(torch.where(act, x_rec.re, x_curr.re),
                      torch.where(act, x_rec.im, x_curr.im))
        n_eff = n_eff + active.to(torch.int32)
        cost_prev = torch.where(active, cost, cost_prev)
        v = torch.where(active, v_next, v)
        if cfg.keep_cost_history:
            history.append(cost_prev)
        # the reference stops after keeping the converged iteration
        if cfg.eps != 0.0 and i > 2:
            active = active & ~(cost < cfg.eps)

    # zero-input short-circuit (reference POCS.py:515-521)
    nonzero = torch.sum(z.abs2(), dim=(-2, -1)) > 0
    nz = nonzero[:, None, None]
    x_out = Cplx(torch.where(nz, x_curr.re, z.re),
                 torch.where(nz, x_curr.im, z.im))
    n_eff = torch.where(nonzero, n_eff, torch.zeros_like(n_eff))
    cost = torch.where(nonzero, cost_prev, torch.zeros_like(cost_prev))
    hist = torch.stack(history) if cfg.keep_cost_history else None
    return POCSResult(x_out, n_eff, cost, hist)


# --- named variants mirroring the reference's partials (POCS.py:659-661) ---
def pocs(z, mask, transform=None, config=POCSConfig()):
    return pocs_interpolate(z, mask, transform,
                            dataclasses.replace(config, version="regular"))


def fpocs(z, mask, transform=None, config=POCSConfig()):
    return pocs_interpolate(z, mask, transform,
                            dataclasses.replace(config, version="fast"))


def apocs(z, mask, transform=None, config=POCSConfig()):
    return pocs_interpolate(z, mask, transform,
                            dataclasses.replace(config, version="adaptive"))
