"""POCS sparse-inversion solver, FFT basis, fixed iteration count.

Counterpart of ``pseudo_3d_interpolation_tpu/models/pocs.py``. Per
iteration: forward transform -> threshold(decay_i) -> inverse transform ->
reinsertion ``x = x_rec·(1 − α·mask) + α·x_obs``; ``version='fast'`` is
FPOCS (Nesterov with O'Donoghue & Candès adaptive restart). Zero slices
short-circuit like the reference (POCS.py:515-521).

One route is ported: ``fused-folded[fft]``, the whole solve per batch in
the CUDA kernel of ``ops/kernels/pocs_solve.py``. A configuration the JAX
package sends elsewhere (the per-iteration kernel or the XLA scan: eps ≠ 0,
cost history, global early stop, ``version='adaptive'``, a mask other than
the exact 2-D slice mask, another basis or threshold) raises
:class:`NotImplementedError` with that route's reason; nothing falls back.
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
    cost_history: torch.Tensor | None  # always None: no history route yet


class SolverRoute(NamedTuple):
    """Solver path for a (shape, mask, config, transform) combination.

    ``route`` is ``'fused-folded'`` (the ported kernel) or the name of the
    JAX package's route that the configuration needs and that is not ported
    yet (``'fused-periter'``, ``'xla-scan'``); ``reason`` is then the first
    failed condition, worded as in the JAX package."""

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
    if not isinstance(transform, FFTTransform):
        kind = getattr(transform, "kind", type(transform).__name__)
        return SolverRoute("xla-scan", "",
                           f"transform {kind!r} has no fused kernel")
    op = "garrote" if cfg.thresh_op == "garotte" else cfg.thresh_op
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
    0 missing), on ``z``'s device; ``transform``: defaults to the config's
    ``transform_kind``.
    """
    cfg = config
    if transform is None:
        transform = get_transform(cfg.transform_kind)
    mask = mask.to(device=z.re.device, dtype=torch.float32).contiguous()
    route = solver_route(z.shape, mask.shape, cfg, transform)
    if route.route != "fused-folded":
        raise NotImplementedError(describe_route(route))

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


# --- named variants mirroring the reference's partials (POCS.py:659-661) ---
def pocs(z, mask, transform=None, config=POCSConfig()):
    return pocs_interpolate(z, mask, transform,
                            dataclasses.replace(config, version="regular"))


def fpocs(z, mask, transform=None, config=POCSConfig()):
    return pocs_interpolate(z, mask, transform,
                            dataclasses.replace(config, version="fast"))
