"""POCS sparse-inversion solver: the FFT, DCT, WAVELET, SHEARLET and
CURVELET bases.

Counterpart of ``pseudo_3d_interpolation_tpu/models/pocs.py``. Per
iteration: forward transform -> threshold(decay_i) -> inverse transform ->
reinsertion ``x = x_rec·(1 − α·mask) + α·x_obs``; ``version='fast'`` is
FPOCS (Nesterov with O'Donoghue & Candès adaptive restart). Zero slices
short-circuit like the reference (POCS.py:515-521).

Four routes:
- ``fused-folded[fft|dct|wavelet]``: the whole fixed-iteration solve per
  batch in the CUDA kernel of ``ops/kernels/pocs_solve.py``;
- ``fused-periter[fft]``: the FFT basis when the configuration needs the
  scan (eps ≠ 0, cost history, global early stop, ``version='adaptive'``),
  each iteration one ``pocs_iteration`` kernel launch;
- ``streamed-subband``: the spectral-stack bases (SHEARLET, CURVELET),
  each iteration's ``inverse(threshold(forward(·)))`` fused in the
  transform's ``apply_threshold`` (the subband kernels on the card:
  ``subband_update`` and ``box_group_update``, or with ``P3D_SPATIAL_IO``
  set ``subband_update_spatial`` and ``box_group_update``). With a
  ``*-percentile`` threshold, which the JAX package runs through its plain
  streamed apply (the route's reason names it), the two kernels run split
  at the threshold, each band's percentile of |c| selected on the card
  between their passes (``ops/kernels/subband.py``'s percentile route and
  ``ops/kernels/percentile.py``); ``P3D_SPATIAL_IO`` does not apply there;
- ``xla-scan``: the JAX package's plain scan, here PyTorch ops on the
  device (``torch.fft``, ``torch.matmul``) and no kernel: the DCT or
  WAVELET basis with eps ≠ 0, cost history, global early stop or
  'adaptive'; a padded or non-square WAVELET; a mask other than the exact
  2-D slice mask; a batch that is not 1-D; the ``*-percentile``
  thresholds; the decimated CURVELET.
The last three share one scan, a Python loop over the iterations with the
state on the device. It carries the scan's options: regular / fast /
adaptive, lane freezing for eps > 0, cost history and ``global_early_stop``
(the one host synchronisation per iteration, taken only when asked for).
Every route :func:`solver_route` gives runs; nothing falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops import wavelet as wv
from ..ops.cplx import Cplx, from_complex, to_complex
from ..ops.kernels.pocs_solve import THRESH_OPS, pocs_iteration, pocs_solve
from ..utils.device import resolve_device
from .transforms import (DCTTransform, FFTTransform, WaveletTransform,
                         _resolve_precision, get_transform)

# fields of the JAX package's POCSConfig that steer the TPU kernels only
# (Pallas on/off, interpret mode); they have no meaning here and are
# dropped wherever a JAX config is read
TPU_ONLY_FIELDS = ("use_pallas", "pallas_interpret")


@dataclasses.dataclass(frozen=True)
class POCSConfig:
    """Solver parameters: the JAX package's POCSConfig without
    :data:`TPU_ONLY_FIELDS` (the kernels are the only routes and take any
    slice shape).

    ``pad_to_tile`` is read by the cube drivers only: ``True`` zero-pads
    every slice to 128-multiple sides with an observed-zero frame
    (amplitude 0, mask 1) before the solve and crops after
    (``utils/pad.pad_slices_to_tile``), a slightly different, equally
    valid POCS problem; ``False`` and ``None`` (the JAX package's
    automatic policy, which engages only for its TPU kernels) solve the
    slices as they are."""

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
    pad_to_tile: bool | None = None


class POCSResult(NamedTuple):
    data: Cplx  # reconstructed slices, same shape as input
    n_iterations: torch.Tensor  # (B,) int32 — effective iterations per slice
    cost: torch.Tensor  # (B,) float32 — final cost per slice
    cost_history: torch.Tensor | None  # (niter, B) when requested


class SolverRoute(NamedTuple):
    """Solver path for a (shape, mask, config, transform) combination.

    ``route`` is ``'fused-folded'`` (a solve kernel), ``'fused-periter'``
    (the FFT basis' scan over the iteration kernel), ``'streamed-subband'``
    (SHEARLET's and CURVELET's directional scan over the subband kernels)
    or ``'xla-scan'`` (the JAX package's plain scan); ``basis``
    the folded kernel's basis ('fft'/'dct'/'wavelet', '' otherwise);
    ``reason`` the first failed folded-kernel condition, worded as in the
    JAX package ('' when the folded kernel runs)."""

    route: str
    basis: str
    reason: str


def runs(route: SolverRoute) -> bool:
    """Whether :func:`pocs_interpolate` runs ``route``: every route
    :func:`solver_route` gives, the directional route with a percentile
    threshold (whose reason names the threshold) included."""
    return route.route in ("fused-folded", "fused-periter",
                           "streamed-subband", "xla-scan")


def _wavelet_kernel_ok(transform: WaveletTransform, h: int, w: int) -> bool:
    """The wavelet solve kernel's gate: square slices with no padding
    target, n divisible by 2**level, the last level at least the filter
    long. (The JAX gate also asked for 128-aligned cascade boundaries, a
    TPU lane rule.)"""
    n, level = w, transform.level
    return (transform.target is None and h == w and level >= 1
            and n % (1 << level) == 0
            and (n >> (level - 1)) >= wv.filter_length(transform.wavelet))


def solver_route(shape, mask_shape, config: POCSConfig,
                 transform=None) -> SolverRoute:
    """The solver-path decision for :func:`pocs_interpolate`, in the JAX
    package's gate order (JAX models/pocs.py:145-255) without its TPU-only
    gates (Pallas on/off, the Mosaic backend, the %128 tiles)."""
    cfg = config
    if transform is None:
        transform = get_transform(cfg.transform_kind)
    if hasattr(transform, "with_shape"):
        transform = transform.with_shape(tuple(shape))
    op = "garrote" if cfg.thresh_op == "garotte" else cfg.thresh_op
    h, w = int(shape[-2]), int(shape[-1])
    if hasattr(transform, "apply_threshold"):
        # the subband kernels take any slice shape; the percentile forms
        # take their split kernels, under the JAX package's reason
        if op not in THRESH_OPS:
            return SolverRoute(
                "streamed-subband", "", f"threshold {cfg.thresh_op!r} has "
                "no kernel (hard/soft/garrote only)")
        return SolverRoute("streamed-subband", "", "")
    if isinstance(transform, (FFTTransform, DCTTransform)):
        basis = "dct" if isinstance(transform, DCTTransform) else "fft"
    elif isinstance(transform, WaveletTransform):
        basis = "wavelet"
    else:
        kind = getattr(transform, "kind", type(transform).__name__)
        return SolverRoute("xla-scan", "",
                           f"transform {kind!r} has no fused kernel")
    batch_ndim = len(shape) - 2
    full_mask = (len(mask_shape) == 2
                 and tuple(mask_shape) == tuple(shape[-2:]))
    if not full_mask:
        return SolverRoute("xla-scan", basis,
                           "mask must be the exact 2-D (H, W) slice mask")
    if batch_ndim != 1:
        return SolverRoute("xla-scan", basis, f"batch must be 1-D (got "
                           f"{batch_ndim}-D leading axes)")
    if op not in THRESH_OPS:
        return SolverRoute("xla-scan", basis, f"threshold {cfg.thresh_op!r} "
                           "has no kernel (hard/soft/garrote only)")
    if basis == "wavelet" and not _wavelet_kernel_ok(transform, h, w):
        return SolverRoute(
            "xla-scan", basis, "wavelet cascade not kernel-eligible (needs "
            "square slices, no resize target, and the last level at least "
            f"the filter long — {h}x{w}, level={transform.level})")

    # folded-solve-only conditions; the FFT basis that fails them still
    # rides the per-iteration kernel inside the scan
    def _periter(reason: str) -> SolverRoute:
        return SolverRoute("fused-periter" if basis == "fft" else "xla-scan",
                           basis, reason)

    if cfg.eps != 0.0:
        return _periter(f"eps={cfg.eps!r} != 0.0 (early stopping needs the "
                        "scan)")
    if cfg.keep_cost_history:
        return _periter("keep_cost_history=True")
    if cfg.global_early_stop:
        return _periter("global_early_stop=True")
    if cfg.version not in ("regular", "fast"):
        return _periter(f"version={cfg.version!r} (folded kernel supports "
                        "regular/fast)")
    return SolverRoute("fused-folded", basis, "")


def describe_route(route: SolverRoute) -> str:
    """One-line description of a :class:`SolverRoute` for driver logs: the
    route, its basis and the first failed kernel gate, as the JAX package
    words it."""
    name = route.route + (f"[{route.basis}]" if route.basis else "")
    return f"{name} — {route.reason}" if route.reason else name


def pocs_interpolate(z: Cplx, mask: torch.Tensor, transform=None,
                     config: POCSConfig = POCSConfig()) -> POCSResult:
    """Run POCS on a batch of slices.

    ``z``: observed data as a ``Cplx`` pair ``(..., H, W)`` (real data has
    a zero imaginary part; the kernel routes take ``(B, H, W)``);
    ``mask``: sampling mask (1 observed, 0 missing), ``(H, W)`` or
    broadcastable to ``z``; ``transform``: defaults to the config's
    ``transform_kind``.
    """
    cfg = config
    if transform is None:
        transform = get_transform(cfg.transform_kind)
    if hasattr(transform, "with_shape"):
        transform = transform.with_shape(z.shape)
    mask = mask.to(device=z.re.device, dtype=torch.float32).contiguous()
    route = solver_route(z.shape, mask.shape, cfg, transform)
    if route.route != "fused-folded":
        return _scan(z, mask, transform, cfg, route)

    # one-time decay schedule from the initial forward transform
    decay = transform.decay(transform.forward(z), cfg.thresh_model,
                            cfg.niter, cfg.p_max, cfg.p_min, cfg.decay_kind)
    mats = None
    if route.basis == "wavelet":
        n = z.shape[-1]
        mats = [wv.dwt_matrix_on(n >> j, transform.wavelet, str(z.re.device))
                for j in range(transform.level)]
        # the decay tree [zero, det_L, ..., det_1] with (niter, B) leaves
        # -> (niter, B, 3·level), deepest level first, each (cH, cV, cD)
        decay = torch.stack([leaf for det in decay[1:] for leaf in det],
                            dim=-1)
    if cfg.sqrt_decay:
        decay = torch.sqrt(decay)
    result, cost = pocs_solve(
        z, mask, decay.to(torch.float32).contiguous(), alpha=cfg.alpha,
        thresh_op=cfg.thresh_op, version=cfg.version,
        precision=_resolve_precision(transform.precision),
        basis=route.basis, wavelet_mats=mats)

    # zero-input short-circuit (reference POCS.py:515-521)
    nonzero = torch.sum(z.abs2(), dim=(-2, -1)) > 0
    nz = nonzero[:, None, None]
    x_out = Cplx(torch.where(nz, result.re, z.re),
                 torch.where(nz, result.im, z.im))
    n_eff = torch.where(nonzero, cfg.niter, 0).to(torch.int32)
    cost = torch.where(nonzero, cost, torch.zeros_like(cost))
    return POCSResult(x_out, n_eff, cost, None)


def _tree_map(fn, tree):
    """``fn`` on every tensor of a decay schedule: a tensor, or the WAVELET
    basis' list of a tensor and tuples of tensors."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _scan(z: Cplx, mask: torch.Tensor, transform, cfg: POCSConfig,
          route: SolverRoute) -> POCSResult:
    """The scan of the JAX package (models/pocs.py:392-534) as a Python
    loop with the state on the device. Each step is one
    ``pocs_iteration`` launch on ``fused-periter``, the transform's fused
    ``apply_threshold`` and the reinsertion on ``streamed-subband``, or
    ``forward`` → ``threshold`` → ``inverse`` and the reinsertion on
    ``xla-scan``. The leading axes of ``(..., H, W)`` slices (and of a
    mask that has them) are flattened into one batch for the loop and
    restored on the result, the iteration counts, the costs and the
    history. A transform with a ``slice_sum`` method (the space-sharded
    FFT basis of ``parallel/solver.py``, whose slices are spread over
    processes) takes the per-slice sums of the cost and of the zero-slice
    test."""
    batch, (h, w) = tuple(z.shape[:-2]), tuple(z.shape[-2:])
    if mask.dim() > 2:
        mask = torch.broadcast_to(mask, z.shape).reshape(-1, h, w)
    z = Cplx(z.re.reshape(-1, h, w).contiguous(),
             z.im.reshape(-1, h, w).contiguous())
    op = "garrote" if cfg.thresh_op == "garotte" else cfg.thresh_op
    b = z.re.shape[0]
    device = z.re.device
    alpha = cfg.alpha
    # one-time decay schedule, (niter, B) or (niter, B, L), or the WAVELET
    # basis' list of them: spectral-stack bases take it from streamed
    # statistics
    if hasattr(transform, "decay_from_input"):
        decay = transform.decay_from_input(
            z, cfg.thresh_model, cfg.niter, cfg.p_max, cfg.p_min,
            cfg.decay_kind)
    else:
        decay = transform.decay(transform.forward(z), cfg.thresh_model,
                                cfg.niter, cfg.p_max, cfg.p_min,
                                cfg.decay_kind)
    if cfg.sqrt_decay:
        decay = _tree_map(torch.sqrt, decay)
    decay = _tree_map(lambda t: t.to(torch.float32), decay)
    keep = 1.0 - alpha * mask  # reinsertion weights
    slice_sum = getattr(transform, "slice_sum", None) or (
        lambda t: torch.sum(t, dim=(-2, -1)))
    a_re, a_im = alpha * z.re, alpha * z.im

    if route.route == "fused-periter":
        precision = _resolve_precision(transform.precision)

        def step(x_in: Cplx, tau: torch.Tensor) -> Cplx:
            return pocs_iteration(x_in, z, mask, tau.contiguous(), alpha, op,
                                  precision)
    elif route.route == "streamed-subband":
        def step(x_in: Cplx, tau: torch.Tensor) -> Cplx:
            rec = transform.apply_threshold(x_in, tau, op)
            return Cplx(rec.re * keep + a_re, rec.im * keep + a_im)
    else:
        def step(x_in: Cplx, tau) -> Cplx:
            rec = transform.inverse(transform.threshold(
                transform.forward(x_in), tau, op))
            return Cplx(rec.re * keep + a_re, rec.im * keep + a_im)

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
        x_rec = step(x_in, _tree_map(lambda t: t[i], decay))

        # cost (Gao et al. 2013): (Σ(|x_new| − |x_curr|))² / (Σ|x_new|)²
        mag_rec = abs_(x_rec)
        d = slice_sum(mag_rec - abs_(x_curr))
        s = slice_sum(mag_rec)
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
    nonzero = slice_sum(z.abs2()) > 0
    nz = nonzero[:, None, None]
    x_out = Cplx(torch.where(nz, x_curr.re, z.re),
                 torch.where(nz, x_curr.im, z.im))
    n_eff = torch.where(nonzero, n_eff, torch.zeros_like(n_eff))
    cost = torch.where(nonzero, cost_prev, torch.zeros_like(cost_prev))
    hist = (torch.stack(history).reshape((-1,) + batch)
            if cfg.keep_cost_history else None)
    return POCSResult(
        Cplx(x_out.re.reshape(batch + (h, w)),
             x_out.im.reshape(batch + (h, w))),
        n_eff.reshape(batch), cost.reshape(batch), hist)


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


def pocs_interpolate_numpy(x, mask, config: POCSConfig = POCSConfig(),
                           transform=None, device=None):
    """Host-boundary convenience: numpy (complex or real) in and out.

    ``x``: (..., H, W) slices; ``mask``: (H, W) or broadcastable to ``x``;
    ``device``: the first CUDA card by default (raising without one),
    ``'cpu'`` for the plain PyTorch versions on the host. Returns
    ``(x_inv, n_iterations, cost)`` as numpy arrays; a real input gives a
    real ``x_inv`` (the imaginary part dropped), as the reference returns
    (POCS.py:653-656)."""
    device = resolve_device(device)
    was_complex = np.iscomplexobj(x)
    z = from_complex(np.asarray(x), device)
    res = pocs_interpolate(
        z, torch.as_tensor(np.asarray(mask, np.float32), device=device),
        transform if transform is not None
        else get_transform(config.transform_kind), config)
    out = to_complex(res.data) if was_complex else res.data.re.cpu().numpy()
    return out, res.n_iterations.cpu().numpy(), res.cost.cpu().numpy()
