"""Stage 2 — POCS interpolation of every frequency (or time) slice of a cube.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/pocs.py``
(replaces the reference's cube_POCS_interpolation_3D.py). The slice axis
is batched on one device; per-slice telemetry (effective iterations, final
cost) comes back as arrays and can be written as one CSV.

YAML parameter compatibility: the ``metadata`` keys of the reference's
POCS config map 1:1 onto :class:`POCSConfig`; dask cluster keys and the
JAX package's TPU-only fields are accepted and ignored. Not ported yet:
netCDF file input and output, ``interpolate_checkpointed`` (HDF5
streaming), ``warmup`` and the profiler trace.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os

import numpy as np

from ..io.cube import Cube
from ..models.pocs import (TPU_ONLY_FIELDS, POCSConfig, describe_route,
                           solver_route)
from ..models.transforms import TRANSFORM_OPTION_KEYS, get_transform
from ..parallel.solver import (fits_resident, interpolate_cube,
                               interpolate_cube_resident, resolve_device)

log = logging.getLogger(__name__)

_DASK_KEYS = ("n_workers", "processes", "threads_per_worker", "memory_limit",
              "batch_chunk")

# Driver-level precision default per basis, applied only when the user
# leaves ``precision`` unset. 'high' was chosen on the TPU (bf16x3, cube-SNR
# neutral there); here the kernel computes it in full fp32, so it equals
# 'highest' until the Hopper mapping is chosen (open ROADMAP item). The
# other bases' entries arrive with those bases.
_PRODUCTION_PRECISION = {"FFT": {"precision": "high"}}


def _production_transform(config: POCSConfig, extra: dict):
    """Build the solve transform from the YAML extras, with the driver's
    precision default where the user left ``precision`` unset."""
    kw = {k: extra[k] for k in TRANSFORM_OPTION_KEYS if k in extra}
    if "precision" not in kw:
        kw.update(_PRODUCTION_PRECISION.get(config.transform_kind, {}))
    return get_transform(config.transform_kind, **kw)


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
    cube: Cube,
    config: POCSConfig | str | dict = POCSConfig(
        niter=50, thresh_op="hard", thresh_model="exponential",
        p_min="adaptive", version="fast", alpha=0.75, eps=0.0,
    ),
    var: str | None = None,
    batch: int = 64,
    runtime_csv: str | None = None,
    verbose: int = 0,
    device=None,
) -> Cube:
    """Interpolate all slices of a cube; the mask derives from the fold
    (fold > 0 -> 1). ``device`` defaults to the first CUDA device when
    there is one. Returns a new :class:`Cube` with ``<var>_interp``."""
    if not isinstance(cube, Cube):
        raise NotImplementedError(
            "interpolate takes an in-memory Cube; netCDF file input is not "
            "ported yet (ROADMAP queue 1 #8)")
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
    device = resolve_device(device)
    h, w = moved.shape[-2], moved.shape[-1]
    # device-resident driver when the cube fits the device's free memory
    resident_batch = min(batch, 32)
    resident = fits_resident(device, moved.shape[0], resident_batch, h, w)
    rt = solver_route((resident_batch, h, w), (h, w), config, transform)
    level = logging.INFO if verbose else logging.DEBUG
    log.log(level, "POCS: %d slices of %dx%d, %s/%s, niter=%d on %s",
            moved.shape[0], h, w, config.transform_kind, config.version,
            config.niter, device)
    log.log(level, "solver path: %s", describe_route(rt))

    def progress(done, total):
        log.debug("  %d/%d slices", done, total)

    if resident:
        rec, n_iters, cost = interpolate_cube_resident(
            moved, mask, config, transform=transform, batch=resident_batch,
            progress=progress, device=device)
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
    return out
