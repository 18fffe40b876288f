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
the solve with torch.profiler. :func:`interpolate_checkpointed` solves
batch by batch into checkpoint files and resumes from them, streaming a
cube file slab by slab; :func:`warmup` builds the kernels and runs one
launch of the driver a production cube would take.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import datetime
import json
import logging
import os
import time

import numpy as np
import torch

from ..io.cube import Cube
from ..models.pocs import (TPU_ONLY_FIELDS, POCSConfig, describe_route,
                           solver_route)
from ..models.transforms import TRANSFORM_OPTION_KEYS, get_transform
from ..ops import curvelet as cv
from ..ops import shearlet as sh
from ..ops.kernels import subband
from ..parallel import solver
from ..parallel.solver import (fits_resident, interpolate_cube,
                               interpolate_cube_resident, resolve_device)
from ..utils.pad import padded_shape

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


def _transform_options(config: POCSConfig, extra: dict) -> dict:
    """The solve transform's options from the YAML extras, with the
    driver's precision default where the user left ``precision`` unset."""
    kw = {k: extra[k] for k in TRANSFORM_OPTION_KEYS if k in extra}
    if "precision" not in kw and not kw.get("decimated"):
        for key, val in _PRODUCTION_PRECISION.get(config.transform_kind,
                                                  {}).items():
            kw.setdefault(key, val)
    return kw


def _production_transform(config: POCSConfig, extra: dict):
    """Build the solve transform from the YAML extras
    (:func:`_transform_options`)."""
    return get_transform(config.transform_kind,
                         **_transform_options(config, extra))


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


def _transform_device_bytes(transform, batch: int, h: int, w: int,
                            thresh_op: str = "hard") -> int:
    """Device memory a basis holds or allocates for one batch beyond its
    slice buffers: a spectral-stack basis's windows, twice (the plan's
    groups and the kernels' full-size pack), the subband kernel's scratch
    (with ``P3D_SPATIAL_IO`` set, ``subband_update_spatial``'s, which adds
    one (B, H, W) spectrum) and what the largest box group's call
    allocates, and with a ``*-percentile`` ``thresh_op`` the split
    kernels' keys with the selection's buffers (float32 per slice, band of
    a chunk or box group and pixel, with each band's histogram and
    candidates: at most the full-size bands' or the largest group's) and
    the full-size bands' kept c_l (complex64 per slice, band and pixel);
    the decimated CURVELET's cropped windows and gather indices."""
    if getattr(transform, "decimated", False):
        # a float32 window and an int64 index per wrapped-grid element
        return sum(p.size * (4 if r is None else 12)
                   for r, _, p in transform._layout(h, w))
    if not _is_spectral_stack(transform):
        return 0
    n_bands = _n_subbands(transform, h, w)
    _, full_idx, boxes = sh._plan_kernel_pack(transform._plan(h, w), h, w)
    box_bytes = max((subband.box_scratch_bytes(batch, lg, len(g.idx_h),
                                               len(g.idx_w), h)
                     for _, lg, g in boxes), default=0)
    percentile = thresh_op.endswith("-percentile")
    keys = (subband.percentile_key_bytes(batch, h, w, max(
        [len(full_idx)] + [lg for _, lg, _ in boxes]))
            + subband.kept_cl_bytes(batch, h, w, len(full_idx))
            if percentile else 0)
    return (2 * n_bands * h * w * 4
            + subband.scratch_bytes(batch, h, w, n_bands,
                                    spatial=sh.spatial_io_default()
                                    and not percentile)
            + box_bytes + keys)


def _driver_plan(config: POCSConfig, transform, n_slices: int, h: int,
                 w: int, batch: int, device):
    """The cube driver :func:`interpolate` takes: ``(resident, resident
    batch, solved (h, w))``. The device-resident driver when the cube and
    one batch's working set at the solved sides (padded under
    ``pad_to_tile``) fit the device's free memory, else the host-chunked
    one."""
    h_b, w_b = padded_shape(config, h, w, transform)
    resident_batch = min(batch, 32)
    resident = fits_resident(
        device, n_slices, resident_batch, h_b, w_b,
        expansion=_transform_subbands(transform, (h_b, w_b), config),
        extra_bytes=_transform_device_bytes(transform, resident_batch, h_b,
                                            w_b, config.thresh_op))
    return resident, resident_batch, (h_b, w_b)


def _pad_note(solved, shape) -> str:
    return " (pad_to_tile engaged)" if tuple(solved) != tuple(shape) else ""


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
    mesh=None,
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

    ``mesh`` (``parallel/mesh.py``, 1-D or 2-D) splits every batch of
    ``batch`` slices (padded to a multiple of its slice axis) over its
    processes (on a 2-D mesh with a split space axis, the FFT basis also
    splits each slice's ilines, and the other bases spread whole slices
    over all its ranks: ``parallel.solver.pocs_interpolate_sharded``):
    every rank passes the same cube, solves its block on
    ``mesh.device`` (``device`` is not read) and gets the whole result;
    only the first rank writes
    ``out_path``, ``runtime_csv`` and the profile. Without a mesh the
    device-resident driver runs when the cube fits, as in the JAX package.

    ``cube`` may be a path to a cube file; ``out_path`` writes the result
    with one slice per chunk and ``<out>_parameter.yml`` (every
    ``POCSConfig`` field) beside it. ``profile_dir`` wraps the solve in
    ``torch.profiler`` and writes its Chrome trace there as
    ``interpolate_trace.json``."""
    device = mesh.device if mesh is not None else resolve_device(device)
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
    resident, resident_batch, (h_b, w_b) = _driver_plan(
        config, transform, moved.shape[0], h, w, batch, device)
    # the device-resident driver is the single-device one
    resident = resident and mesh is None
    rt = solver_route((resident_batch, h_b, w_b), (h_b, w_b), config,
                      transform)
    level = logging.INFO if verbose else logging.DEBUG
    log.log(level, "POCS: %d slices of %dx%d, %s/%s, niter=%d on %s",
            moved.shape[0], h, w, config.transform_kind, config.version,
            config.niter, device)
    log.log(level, "solver path: %s%s", describe_route(rt),
            _pad_note((h_b, w_b), (h, w)))

    def progress(done, total):
        log.debug("  %d/%d slices", done, total)

    writer = mesh is None or mesh.index == 0
    with _profiled(profile_dir if writer else None, device):
        if resident:
            rec, n_iters, cost = interpolate_cube_resident(
                moved, mask, config, transform=transform,
                batch=resident_batch, progress=progress, device=device)
        else:
            rec, n_iters, cost = interpolate_cube(
                moved, mask, config, transform=transform, batch=batch,
                progress=progress, device=device, mesh=mesh)
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

    if runtime_csv and writer:
        _write_runtime_csv(runtime_csv, slice_dim, cube.coords[slice_dim],
                           n_iters, cost)
    if out_path and writer:
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


def interpolate_checkpointed(
    cube: Cube | str,
    config: POCSConfig | str | dict,
    checkpoint_dir: str,
    var: str | None = None,
    mesh=None,
    batch: int = 64,
    out_path: str | None = None,
    runtime_csv: str | None = None,
    verbose: int = 0,
    device=None,
) -> Cube | str:
    """Checkpointed interpolation: out of core, with resume.

    Each batch of slices is solved by the host-chunked driver and written
    to ``checkpoint_dir/slices_<start:05d>_<stop:05d>.nc`` as soon as it
    completes; a rerun skips the batches whose file exists. The short tail
    batch is padded with zero slices to the full batch (they short-circuit
    to zero) and cut back. ``checkpoint_meta.json`` holds the run's
    fingerprint (``dataclasses.asdict`` of the config, the transform
    options, the variable, the slice count and the slice shape); a
    directory whose fingerprint differs raises ``ValueError`` ("different
    run") instead of merging two runs. This package's config has no
    TPU-only fields, so a directory the JAX package wrote fingerprints
    differently and is refused, not merged; the slice files themselves
    are the same netCDF layout in both packages.

    Out of core: with a path input (``out_path`` required), the slices
    stream from the file to the device and back to ``out_path`` in
    ``batch``-sized slabs, and the cube is never whole in host RAM; the
    return value is ``out_path``. A :class:`Cube` input returns the
    assembled Cube (also written to ``out_path`` when given). ``device``
    defaults to the first CUDA card; ``device='cpu'`` runs on the host.

    ``mesh`` (``parallel/mesh.py``, 1-D or 2-D): the batch is padded to a
    multiple of its slice axis and each is solved across it
    (``interpolate_cube``'s mesh
    path); every rank passes the same input and gets the same return
    value. The first rank alone decides which batches to resume (the
    others follow its broadcast choice) and writes every file; the others
    read the checkpoints only after a barrier.
    """
    from ..io.ncio import CubeFile, CubeWriter, read_cube, write_cube
    from ..parallel import mesh as mesh_lib

    device = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.index == 0
    extra = {}
    if not isinstance(config, POCSConfig):
        config, extra = config_from_yaml(config)
    streaming = isinstance(cube, (str, os.PathLike))
    if streaming and not out_path:
        raise ValueError("out-of-core mode (path input) requires out_path")
    src = CubeFile(cube) if streaming else cube
    level = logging.INFO if verbose else logging.DEBUG
    try:
        if var is None:
            var = src.primary_var()
        if streaming:
            dims = src.dims_of(var)
            is_complex = src.is_complex(var)
            fold = np.asarray(src.read("fold"))
        else:
            dims, data = src.data_vars[var]
            is_complex = np.iscomplexobj(data)
            fold = np.asarray(src.data_vars["fold"][1])
        mask = (fold > 0).astype(np.float32)
        slice_dim = dims[-1]
        coords = {d: np.asarray(src.coords[d]) for d in src.coords}
        f_total = len(coords[slice_dim])

        if writer:
            os.makedirs(checkpoint_dir, exist_ok=True)
        batch = max(1, min(batch, f_total))
        if mesh is not None:
            batch = mesh_lib.pad_to_multiple(batch, mesh.slice_shards)
        transform_kwargs = _transform_options(config, extra)
        transform = get_transform(config.transform_kind, **transform_kwargs)
        fingerprint = {
            "config": dataclasses.asdict(config),
            "transform_kwargs": transform_kwargs,
            "var": var,
            "f_total": int(f_total),
            "slice_shape": [int(len(coords[d])) for d in dims[:-1]],
        }
        meta_path = os.path.join(checkpoint_dir, "checkpoint_meta.json")
        if mesh is not None:
            mesh_lib.barrier(mesh)  # the first rank made the directory
        resumed = os.path.exists(meta_path)
        if resumed:
            with open(meta_path) as fh:
                prior = json.load(fh)
            if prior != fingerprint:
                raise ValueError(
                    f"checkpoint_dir {checkpoint_dir!r} holds checkpoints "
                    f"from a different run (config/transform/var/shape "
                    f"changed) — clear it or pick another directory. "
                    f"Prior: {prior}")
        if mesh is not None:
            mesh_lib.barrier(mesh)  # every rank has read the prior one
        if writer and not resumed:
            with open(meta_path, "w") as fh:
                json.dump(fingerprint, fh)

        h, w = fingerprint["slice_shape"]
        h_b, w_b = padded_shape(config, h, w, transform)
        rt = solver_route((batch, h_b, w_b), (h_b, w_b), config, transform)
        log.log(level, "solver path: %s%s", describe_route(rt),
                _pad_note((h_b, w_b), (h, w)))

        n_iters = np.zeros(f_total, np.int32)
        costs = np.zeros(f_total, np.float32)
        ck_paths = []
        for start in range(0, f_total, batch):
            stop = min(start + batch, f_total)
            ck = os.path.join(checkpoint_dir,
                              f"slices_{start:05d}_{stop:05d}.nc")
            ck_paths.append((start, stop, ck))
            if _first_rank_says(mesh, os.path.exists(ck)):
                part = read_cube(ck, variables=["niterations", "cost"])
                n_iters[start:stop] = part["niterations"]
                costs[start:stop] = part["cost"]
                log.log(level, "resume: batch %d-%d from checkpoint", start,
                        stop)
                continue
            if streaming:
                slab = src.read_slab(var, dim=slice_dim, start=start,
                                     stop=stop)
            else:
                slab = np.asarray(src.data_vars[var][1][..., start:stop])
            moved = np.moveaxis(slab, -1, 0)
            nb = stop - start
            if nb < batch:  # the tail, padded with zero slices
                moved = np.concatenate(
                    [moved, np.zeros((batch - nb,) + moved.shape[1:],
                                     moved.dtype)])
            rec_c, n_c, c_c = solver.interpolate_cube(
                moved, mask, config, transform=transform, batch=batch,
                device=device, mesh=mesh)
            rec_c, n_c, c_c = rec_c[:nb], n_c[:nb], c_c[:nb]
            n_iters[start:stop] = n_c
            costs[start:stop] = c_c
            part = Cube(
                coords={slice_dim: coords[slice_dim][start:stop]},
                data_vars={"rec": ((slice_dim,) + dims[:-1], rec_c),
                           "niterations": ((slice_dim,), n_c),
                           "cost": ((slice_dim,), c_c)})
            for d in dims[:-1]:
                part.coords[d] = coords[d]
            if writer:
                write_cube(ck, part)
            log.log(level, "batch %d-%d done -> %s", start, stop, ck)
        if mesh is not None:
            mesh_lib.barrier(mesh)  # every checkpoint is written

        if runtime_csv and writer:
            _write_runtime_csv(runtime_csv, slice_dim, coords[slice_dim],
                               n_iters, costs)
        history = f"POCS({config.transform_kind},{config.version},checkpointed)"
        attrs = dict(src.attrs)
        attrs["history"] = attrs.get("history", "") + f"{history};"
        attrs["text"] = (attrs.get("text", "")
                         + f"\n{datetime.date.today().isoformat()}: {history}")
        attrs["pocs_mean_iterations"] = float(n_iters.mean())

        if streaming:
            if not writer:
                mesh_lib.barrier(mesh)  # the first rank writes out_path
                return out_path
            # the checkpoints merged into the output slab by slab
            with CubeWriter(out_path, coords, attrs=attrs,
                            coord_attrs=dict(src.coord_attrs)) as wr:
                wr.create_var(f"{var}_interp", dims,
                              np.complex64 if is_complex else np.float32,
                              chunks={slice_dim: 1},
                              attrs=dict(src.var_attrs.get(var, {})))
                wr.create_var("fold", src.dims_of("fold"), fold.dtype)
                wr.write_slab("fold", fold)
                for start, _, ck in ck_paths:
                    wr.write_slab(f"{var}_interp",
                                  np.moveaxis(read_cube(ck)["rec"], 0, -1),
                                  dim=slice_dim, start=start)
            if mesh is not None:
                mesh_lib.barrier(mesh)
            return out_path
    finally:
        if streaming:
            src.close()

    rec = np.empty((f_total,) + tuple(len(coords[d]) for d in dims[:-1]),
                   np.complex64 if is_complex else np.float32)
    for start, stop, ck in ck_paths:
        rec[start:stop] = read_cube(ck)["rec"]
    out = Cube(
        coords=coords,
        data_vars={f"{var}_interp": (dims, np.moveaxis(rec, 0, -1)),
                   "fold": src.data_vars["fold"]},
        attrs=attrs,
        var_attrs={f"{var}_interp": dict(src.var_attrs.get(var, {}))},
        coord_attrs=dict(src.coord_attrs),
    )
    if out_path and writer:
        write_cube(out_path, out, chunks={slice_dim: 1})
    return out


def _first_rank_says(mesh, flag: bool) -> bool:
    """``flag`` as the mesh's first rank has it (one broadcast over all
    its ranks, 1-D or 2-D), so that every rank takes the same branch;
    ``flag`` itself without a mesh."""
    from ..parallel import mesh as mesh_lib

    if mesh is None:
        return flag
    mesh = mesh_lib.whole(mesh)
    if mesh.size == 1:
        return flag
    import torch.distributed as dist

    t = torch.tensor([int(flag)], device=mesh.device)
    dist.broadcast(t, src=mesh.ranks[0], group=mesh.group)
    return bool(t.item())


def warmup(config, shape, batch: int = 64, mesh=None, verbose: int = 0,
           n_slices: int | None = None, device=None) -> float:
    """Build the kernel libraries and run one launch of the driver a
    production cube would take; returns the wall seconds.

    ``shape``: the production slice (h, w), unpadded (the drivers pad
    under ``pad_to_tile`` as in production); ``n_slices``: the production
    cube's slice count (by default one batch). The choice is
    :func:`interpolate`'s, on the padded budget: the device-resident
    driver, one batch of ``min(batch, 32)`` random slices in a cube of
    ``n_slices`` zero slices, or the host-chunked driver on one batch.
    With a ``mesh`` (never the resident driver, as in :func:`interpolate`)
    the batch is padded to a multiple of its slice axis and solved across
    it.
    The JAX package's persistent compilation cache has no counterpart:
    the kernels are built once per source and flags
    (``ops/kernels/_build``), and eager PyTorch compiles nothing else.
    """
    from ..parallel import mesh as mesh_lib

    device = mesh.device if mesh is not None else resolve_device(device)
    extra = {}
    if not isinstance(config, POCSConfig):
        config, extra = config_from_yaml(config)
    transform = _production_transform(config, extra)
    h, w = int(shape[0]), int(shape[1])
    rng = np.random.default_rng(0)
    mask = (rng.uniform(size=(h, w)) < 0.5).astype(np.float32)

    def noise(b):
        return (rng.normal(size=(b, h, w)).astype(np.float32)
                + 1j * rng.normal(size=(b, h, w)).astype(np.float32))

    t0 = time.perf_counter()
    if device.type == "cuda":
        from ..ops.kernels import _build

        _build.build()
    b_res = min(batch, 32)
    f_total = int(n_slices) if n_slices else b_res
    resident, _, (h_b, w_b) = _driver_plan(config, transform, f_total, h, w,
                                           batch, device)
    if resident and mesh is None:
        b = min(b_res, f_total)
        data = np.zeros((f_total, h, w), np.complex64)
        data[:b] = noise(b)
        interpolate_cube_resident(data, mask, config, transform=transform,
                                  batch=b, device=device, _max_launches=1)
    else:
        b = min(batch, int(n_slices)) if n_slices else batch
        if mesh is not None:
            b = mesh_lib.pad_to_multiple(b, mesh.slice_shards)
        interpolate_cube(noise(b).astype(np.complex64), mask, config,
                         transform=transform, batch=b, device=device,
                         mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    log.log(logging.INFO if verbose else logging.DEBUG,
            "warmup: %s/%s, %s driver, (%d,%d,%d)%s built and run in %.1f s",
            config.transform_kind, config.version,
            "resident" if resident and mesh is None else "host-chunked", b,
            h, w,
            _pad_note((h_b, w_b), (h, w)), dt)
    return dt


def _write_runtime_csv(path, slice_dim, coord, n_iters, costs):
    """One row per slice: its coordinate, effective iterations, cost."""
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow([slice_dim, "niterations", "cost"])
        writer.writerows(zip(np.asarray(coord).tolist(), n_iters.tolist(),
                             costs.tolist()))
