"""Stage 2 — POCS interpolation of every frequency (or time) slice of a cube.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/pocs.py``
(replaces the reference's cube_POCS_interpolation_3D.py). The slice axis
is batched on one device; per-slice telemetry (effective iterations, final
cost) comes back as arrays and can be written as one CSV.

YAML parameter compatibility: the ``metadata`` keys of the reference's
POCS config map 1:1 onto :class:`POCSConfig`; dask cluster keys and the
JAX package's TPU-only fields are accepted and ignored. A path input and
``out_path`` are netCDF cube files (host, h5py), the output written
slice-major with the solver parameters beside it; ``profile_dir`` traces
the solve with torch.profiler. Not ported yet: ``interpolate_checkpointed``
(HDF5 streaming) and ``warmup`` (ROADMAP queue 1 #8).
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import logging
import os

import numpy as np
import torch

from ..io.cube import Cube
from ..models.pocs import (TPU_ONLY_FIELDS, POCSConfig, describe_route,
                           solver_route)
from ..models.transforms import TRANSFORM_OPTION_KEYS, get_transform
from ..ops import curvelet as cv
from ..ops import shearlet as sh
from ..ops.kernels import subband
from ..parallel.solver import (fits_resident, interpolate_cube,
                               interpolate_cube_resident, resolve_device)

log = logging.getLogger(__name__)

_DASK_KEYS = ("n_workers", "processes", "threads_per_worker", "memory_limit",
              "batch_chunk")

# Driver-level precision default per basis, applied only when the user
# leaves ``precision`` unset (JAX pipeline/pocs.py:57-63). 'high' was chosen
# on the TPU (bf16x3, cube-SNR neutral there); here the kernels compute it
# in full fp32, so it equals 'highest' until the Hopper mapping is chosen
# (open ROADMAP item). CURVELET's mix (full-size bands 'high', box groups
# 'highest') kept the TPU's cube SNR there.
_PRODUCTION_PRECISION = {"FFT": {"precision": "high"},
                         "DCT": {"precision": "high"},
                         "WAVELET": {"precision": "high"},
                         "SHEARLET": {"precision": "high"},
                         "CURVELET": {"precision": "high",
                                      "box_precision": "highest"}}


def _production_transform(config: POCSConfig, extra: dict):
    """Build the solve transform from the YAML extras, with the driver's
    precision default where the user left ``precision`` unset."""
    kw = {k: extra[k] for k in TRANSFORM_OPTION_KEYS if k in extra}
    if "precision" not in kw and not kw.get("decimated"):
        for key, val in _PRODUCTION_PRECISION.get(config.transform_kind,
                                                  {}).items():
            kw.setdefault(key, val)
    return get_transform(config.transform_kind, **kw)


def _is_spectral_stack(transform) -> bool:
    """A SHEARLET or an undecimated CURVELET: the streamed directional
    route and its kernels."""
    return hasattr(transform, "apply_threshold")


def _n_subbands(transform, h: int, w: int) -> int:
    """The subband count of a directional basis at (h, w)."""
    if transform.kind == "CURVELET":
        return cv.n_subbands(transform.nbscales or cv.default_nbscales(h, w),
                             transform.nbangles_coarse,
                             transform.allcurvelets)
    return sh.n_subbands(transform.n_scales or sh.default_scales(h, w))


def _transform_subbands(transform, slice_shape, config: POCSConfig) -> int:
    """Per-batch working-set expansion of a basis against the folded
    solve's (``fits_resident``'s ``expansion``). A folded solve (FFT, DCT,
    WAVELET): 1. A scan over the iteration kernel (``fused-periter``) or
    over the transforms (``xla-scan`` on FFT, DCT and WAVELET) keeps about
    eleven pairs per slice (the observation scaled by α, x_prev, x_curr,
    the extrapolated input, the coefficients before and after the
    threshold or the kernel's work pair, the result, their replacements
    while the old ones live, the cost's temporaries), 2. The decimated
    CURVELET has no streamed apply: its scan holds every band's wrapped
    coefficients, budgeted as L slices as the JAX package does. A
    spectral-stack basis with the streamed iteration and the streamed
    decay never holds the (B, L, H, W) stack: its scan keeps about sixteen
    pairs per slice (the iterates, the spectrum, the accumulator, the
    inverse and the cost's temporaries), 2. When the decay model needs the
    coefficients themselves (data-driven, non-'values' kinds,
    inverse-proportional) the forward stack is materialised once per
    batch: L."""
    h, w = int(slice_shape[-2]), int(slice_shape[-1])
    if getattr(transform, "decimated", False):
        return _n_subbands(transform, h, w)
    if not _is_spectral_stack(transform):
        route = solver_route((1, h, w), (h, w), config, transform)
        return 1 if route.route == "fused-folded" else 2
    if not transform._needs_full_forward(
            config.thresh_model, config.decay_kind):
        return 2
    return _n_subbands(transform, h, w)


def _transform_device_bytes(transform, batch: int, h: int, w: int) -> int:
    """Device memory a basis holds or allocates for one batch beyond its
    slice buffers: a spectral-stack basis's windows, twice (the plan's
    groups and the kernels' full-size pack), the subband kernel's scratch
    (with ``P3D_SPATIAL_IO`` set, ``subband_update_spatial``'s, which adds
    one (B, H, W) spectrum) and what the largest box group's call
    allocates; the decimated CURVELET's cropped windows and gather
    indices."""
    if getattr(transform, "decimated", False):
        # a float32 window and an int64 index per wrapped-grid element
        return sum(p.size * (4 if r is None else 12)
                   for r, _, p in transform._layout(h, w))
    if not _is_spectral_stack(transform):
        return 0
    n_bands = _n_subbands(transform, h, w)
    boxes = sh._plan_kernel_pack(transform._plan(h, w), h, w)[2]
    box_bytes = max((subband.box_scratch_bytes(batch, lg, len(g.idx_h),
                                               len(g.idx_w), h)
                     for _, lg, g in boxes), default=0)
    return (2 * n_bands * h * w * 4
            + subband.scratch_bytes(batch, h, w, n_bands,
                                    spatial=sh.spatial_io_default())
            + box_bytes)


def config_from_yaml(path_or_dict) -> tuple[POCSConfig, dict]:
    """Load a reference-style POCS parameter YAML (path or dict) into a
    :class:`POCSConfig` plus the extra (transform) options."""
    if isinstance(path_or_dict, (str, os.PathLike)):
        import yaml

        with open(path_or_dict) as f:
            cfg = yaml.safe_load(f)
    else:
        cfg = dict(path_or_dict)
    meta = dict(cfg.get("metadata", cfg))
    ignored = sorted(k for k in _DASK_KEYS + TPU_ONLY_FIELDS
                     if k in cfg or k in meta)
    if ignored:
        log.debug("ignoring dask cluster / TPU-only keys: %s", ignored)
    fields = {f.name for f in dataclasses.fields(POCSConfig)}
    kwargs = {k: v for k, v in meta.items() if k in fields}
    extra = {k: v for k, v in meta.items()
             if k not in fields and k not in TPU_ONLY_FIELDS}
    tolerated = set(TRANSFORM_OPTION_KEYS) | set(_DASK_KEYS) | {
        "dim", "var", "apply_filter", "output_runtime_results", "verbose"}
    unknown = set(extra) - tolerated
    if unknown:
        raise ValueError(
            f"unrecognized POCS YAML option(s) {sorted(unknown)}; "
            f"recognized non-POCSConfig keys: {sorted(tolerated)}")
    return POCSConfig(**kwargs), extra


def interpolate(
    cube: Cube | str,
    config: POCSConfig | str | dict = POCSConfig(
        niter=50, thresh_op="hard", thresh_model="exponential",
        p_min="adaptive", version="fast", alpha=0.75, eps=0.0,
    ),
    var: str | None = None,
    batch: int = 64,
    out_path: str | None = None,
    runtime_csv: str | None = None,
    profile_dir: str | None = None,
    verbose: int = 0,
    device=None,
) -> Cube:
    """Interpolate all slices of a cube; the mask derives from the fold
    (fold > 0 -> 1). ``device`` defaults to the first CUDA device and
    raises without one; ``device='cpu'`` runs the plain PyTorch versions on
    the host. Returns a new :class:`Cube` with ``<var>_interp``.

    ``cube`` may be a path to a cube file; ``out_path`` writes the result
    with one slice per chunk and ``<out>_parameter.yml`` (every
    ``POCSConfig`` field) beside it. ``profile_dir`` wraps the solve in
    ``torch.profiler`` and writes its Chrome trace there as
    ``interpolate_trace.json``."""
    device = resolve_device(device)
    if isinstance(cube, (str, os.PathLike)):
        from ..io.ncio import read_cube

        cube = read_cube(cube)
    extra = {}
    if not isinstance(config, POCSConfig):
        config, extra = config_from_yaml(config)
    if var is None:
        var = cube.primary_var()
    dims, data = cube.data_vars[var]
    if "fold" not in cube.data_vars:
        raise ValueError("cube needs a 'fold' variable to derive the "
                         "sampling mask")
    mask = (np.asarray(cube.data_vars["fold"][1]) > 0).astype(np.float32)

    # slice axis first: (il, xl, F) -> (F, il, xl)
    slice_dim = dims[-1]
    moved = np.moveaxis(np.asarray(data), -1, 0)
    transform = _production_transform(config, extra)
    h, w = moved.shape[-2], moved.shape[-1]
    # device-resident driver when the cube fits the device's free memory
    resident_batch = min(batch, 32)
    resident = fits_resident(
        device, moved.shape[0], resident_batch, h, w,
        expansion=_transform_subbands(transform, (h, w), config),
        extra_bytes=_transform_device_bytes(transform, resident_batch, h, w))
    rt = solver_route((resident_batch, h, w), (h, w), config, transform)
    level = logging.INFO if verbose else logging.DEBUG
    log.log(level, "POCS: %d slices of %dx%d, %s/%s, niter=%d on %s",
            moved.shape[0], h, w, config.transform_kind, config.version,
            config.niter, device)
    log.log(level, "solver path: %s", describe_route(rt))

    def progress(done, total):
        log.debug("  %d/%d slices", done, total)

    with _profiled(profile_dir, device):
        if resident:
            rec, n_iters, cost = interpolate_cube_resident(
                moved, mask, config, transform=transform,
                batch=resident_batch, progress=progress, device=device)
        else:
            rec, n_iters, cost = interpolate_cube(
                moved, mask, config, transform=transform, batch=batch,
                progress=progress, device=device)
    rec = np.moveaxis(rec, 0, -1)

    out = Cube(
        coords=dict(cube.coords),
        data_vars={
            f"{var}_interp": (dims, rec),
            "fold": cube.data_vars["fold"],
        },
        attrs=dict(cube.attrs),
        var_attrs={f"{var}_interp": dict(cube.var_attrs.get(var, {}))},
        coord_attrs=dict(cube.coord_attrs),
    )
    out.append_history(
        f"POCS({config.transform_kind},{config.version},niter={config.niter},"
        f"thresh={config.thresh_op}/{config.thresh_model})")
    out.attrs["pocs_mean_iterations"] = float(n_iters.mean())
    out.attrs["pocs_mean_cost"] = float(cost.mean())

    if runtime_csv:
        with open(runtime_csv, "w", newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow([slice_dim, "niterations", "cost"])
            writer.writerows(zip(np.asarray(cube.coords[slice_dim]).tolist(),
                                 n_iters.tolist(), cost.tolist()))
    if out_path:
        import yaml

        from ..io.ncio import write_cube

        write_cube(out_path, out, chunks={slice_dim: 1})
        # the exact solver parameters beside the output, every field
        with open(os.path.splitext(out_path)[0] + "_parameter.yml",
                  "w") as fh:
            yaml.safe_dump({"metadata": dataclasses.asdict(config)}, fh)
    return out


@contextlib.contextmanager
def _profiled(profile_dir, device):
    """torch.profiler around the block when ``profile_dir`` is given (the
    card's activity too on a CUDA device); the Chrome trace lands in
    ``profile_dir/interpolate_trace.json``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          "interpolate_trace.json"))
