"""Sharded stage-2 core: FFT -> POCS -> IFFT over a mesh of processes.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/stage2.py``
(replaces the reference running its whole stage 2 under one dask
cluster, cube_POCS_interpolation_3D.py:291-340, with on-disk transposes
between layout-incompatible stages, cube_binning_3D.py:1313-1351). The
span between the host steps (binning and preprocess before, postprocess
and export after) runs on the mesh's devices in three stages:

1. time -> frequency, trace-parallel: each rank transforms its block of
   ilines along time (no communication), windows the spectrum and moves
   the frequency axis first; one ``all_to_all`` (``mesh.reshard_axis``)
   then gives each rank its block of frequency slices over every iline;
2. POCS, slice-parallel: each rank solves its slices, in batches;
3. frequency -> time, trace-parallel: the mirror of (1), the
   ``all_to_all`` first, then the inverse along time.

A 2-D slice × space mesh runs the three stages over all its ranks
(``mesh.whole``): each rank solves whole frequency slices. Every rank is
given the same full host cube and returns the full result, gathered
(``parallel/mesh.py``'s contract); nothing goes back to the host between
the upload of the time cube and the download of the reconstruction.
There is no compilation cache to warm: the kernels are built once per
source (``ops/kernels/_build``).
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch

from ..io.cube import Cube
from ..models.pocs import POCSConfig, pocs_interpolate
from ..ops import spectral
from ..ops.cplx import Cplx
from ..parallel import mesh as mesh_lib
from ..utils import timing
from ..utils.pad import auto_pad_to_tile, next_multiple
from ..utils.rescale import rescale

log = logging.getLogger(__name__)


def _pad_axis(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``t`` with zeros appended along ``axis`` up to length ``n``."""
    extra = n - t.shape[axis]
    if extra <= 0:
        return t
    shape = list(t.shape)
    shape[axis] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=axis)


def _global_range(mesh, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(min, max) over every rank's ``x``, NaNs left out (NaN when every
    value is NaN), as ``utils.rescale.nan_range`` takes them on one
    device."""
    nan = torch.isnan(x)
    lo = torch.where(nan, math.inf, x).amin().reshape(1)
    hi = torch.where(nan, -math.inf, x).amax().reshape(1)
    mesh_lib.all_reduce(mesh, lo, torch.distributed.ReduceOp.MIN)
    mesh_lib.all_reduce(mesh, hi, torch.distributed.ReduceOp.MAX)
    if bool(torch.isinf(lo) & torch.isinf(hi) & (lo > hi)):
        lo = hi = torch.full((1,), math.nan, device=x.device)
    return lo[0], hi[0]


def _solve_block(z: Cplx, mask: torch.Tensor, transform, config,
                 batch: int):
    """POCS on this rank's (f, H, W) block, ``batch`` slices a launch, on
    the block's device: (Cplx, n_iterations, cost)."""
    f = z.shape[0]
    rec = Cplx(torch.empty_like(z.re), torch.empty_like(z.im))
    iters = torch.empty(f, dtype=torch.int32, device=z.re.device)
    cost = torch.empty(f, dtype=torch.float32, device=z.re.device)
    for i, start in enumerate(range(0, f, batch)):
        stop = min(start + batch, f)
        with timing.span("solver.batch", slices=stop - start, batch=i):
            res = pocs_interpolate(Cplx(z.re[start:stop], z.im[start:stop]),
                                   mask, transform, config)
            rec.re[start:stop] = res.data.re
            rec.im[start:stop] = res.data.im
            iters[start:stop] = res.n_iterations
            cost[start:stop] = res.cost
    return rec, iters, cost


def interpolate_time_cube_sharded(
    cube: Cube | str,
    config: POCSConfig,
    mesh=None,
    var: str | None = None,
    real: bool = True,
    upsample: int = 1,
    filter_type: str | None = None,
    filter_freqs=None,
    drop_filtered: bool = False,
    envelope_clip: bool = False,
    rescale_minmax: tuple[float, float] | None = None,
    transform_kwargs: dict | None = None,
    out_path: str | None = None,
    verbose: int = 0,
    batch: int = 32,
    timings: dict | None = None,
) -> Cube:
    """Run steps 12-14 (FFT, POCS, IFFT) over ``mesh`` (default
    :func:`parallel.mesh.make_mesh`), each rank on ``mesh.device``. A 2-D
    mesh runs the three stages over all its ranks (``mesh.grid``, row-
    major), as the JAX function shares the frequency slices among all
    the devices of any mesh: each rank solves whole slices, every basis.

    Equivalent to ``apply_ifft(interpolate(apply_fft(cube)))`` with the
    same options (the same operations, scaling and solver; the frequency
    window and ``drop_filtered`` of ``apply_fft``, ``envelope_clip`` and
    ``rescale_minmax`` of ``apply_ifft``, the rescale's range taken over
    the whole cube). Each rank solves its block of the frequency slices
    ``batch`` at a time. Under ``pad_to_tile`` the grid gets an
    observed-zero frame of zero traces (mask 1): a zero trace transforms
    to zero in every frequency slice, so the solver sees the frame the
    cube drivers build. The iline axis is padded with zero ilines to a
    multiple of the mesh for the trace-parallel stages and cropped right
    after the ``all_to_all``, so the solver sees the unpadded problem.
    Returns, on every rank, the time-domain cube with the interpolated
    variable named like ``var`` and ``fold``, its history and the
    ``pocs_mean_*`` attributes; the first rank writes ``out_path``.
    ``timings``, when given, receives this rank's walls in seconds, each
    ended by a device synchronisation: ``upload`` (its block of ilines
    to the device), ``solve`` (FFT, POCS and IFFT with their
    all_to_alls) and ``download`` (the gather and the copy to the
    host); and the cube's ``spans`` and the process's build counters
    (``process``), as ``utils.timing.cube`` records them: the laps
    ``stage2.upload``, ``stage2.solve`` and ``stage2.download`` between
    ``stage2.host_in`` and ``stage2.host_out``, and inside them the
    copies (``stage2.h2d``, ``stage2.d2h``), the FFTs (``stage2.rfft``,
    ``stage2.irfft``), each batch's solve (``solver.batch``), the
    result's statistics (``stage2.stats``) and the mesh's collectives
    (``mesh.*``). Without ``timings`` the steps are profiler ranges
    only."""
    from .pocs import _production_transform, config_from_yaml

    if mesh is None:
        mesh = mesh_lib.make_mesh()
    mesh = mesh_lib.whole(mesh)  # a 2-D mesh: the 1-D mesh of its ranks
    n_dev, device = mesh.size, mesh.device
    with timing.cube(timings, device) as laps:
        with timing.span("stage2.host_in"):
            if isinstance(cube, (str, os.PathLike)):
                from ..io.ncio import read_cube

                cube = read_cube(cube)
            if not isinstance(config, POCSConfig):
                config, _ = config_from_yaml(config)
            if var is None:
                var = cube.primary_var()
            dims, data = cube.data_vars[var]
            if dims[-1] != "twt":
                raise ValueError(f"{var} must have twt as its last axis, "
                                 f"has {dims}")
            if "fold" not in cube.data_vars:
                raise ValueError("cube needs a 'fold' variable to derive "
                                 "the sampling mask")
            twt = np.asarray(cube.coords["twt"], np.float64)
            data = np.asarray(data, np.float32)
            mask = (np.asarray(cube.data_vars["fold"][1]) > 0).astype(
                np.float32)
            transform = _production_transform(config, transform_kwargs or {})

            il0, xl0 = data.shape[0], data.shape[1]
            if auto_pad_to_tile(config, il0, xl0, transform):
                il_t, xl_t = next_multiple(il0, 128), next_multiple(xl0, 128)
                data = np.pad(data, ((0, il_t - il0), (0, xl_t - xl0),
                                     (0, 0)))
                mask = np.pad(mask, ((0, il_t - il0), (0, xl_t - xl0)),
                              constant_values=1.0)

            # the spectral bookkeeping of ops/spectral, on the host
            n = data.shape[-1]
            if n % 2 != 0:
                n -= 1
                twt = twt[:n]
            nfft = int(upsample) * n
            dt = float(np.mean(np.diff(twt)))
            t0 = float(twt[0])
            freqs_full = (np.fft.rfftfreq(nfft, dt) if real
                          else np.fft.fftfreq(nfft, dt))
            window, f_kept = None, len(freqs_full)
            if filter_type is not None:
                if filter_freqs is None:
                    raise ValueError("filter frequencies must be specified")
                window = spectral.freq_filter_window(
                    freqs_full, list(filter_freqs), filter_type)
                if drop_filtered:
                    if filter_type != "lowpass":
                        raise ValueError("drop_filtered only supported for "
                                         "lowpass filters")
                    if not real:
                        raise ValueError("drop_filtered requires the rfft "
                                         "layout (real=True)")
                    f_kept = int(np.count_nonzero(
                        freqs_full <= max(filter_freqs)))
            freqs = freqs_full[:f_kept]  # the dropped bins: a contiguous tail
            f_pad = mesh_lib.pad_to_multiple(f_kept, n_dev)  # zero slices
            il = data.shape[0]
            il_pad = mesh_lib.pad_to_multiple(il, n_dev)
            level = logging.INFO if verbose else logging.DEBUG
            log.log(level, "stage2 sharded: %s cube -> %d freq slices (pad "
                    "%d) over a mesh of %d, %s/%s, niter=%d", data.shape,
                    f_kept, f_pad, n_dev, config.transform_kind,
                    config.version, config.niter)

        def to_slices(t: torch.Tensor) -> torch.Tensor:
            t = _pad_axis(t[..., :f_kept].movedim(-1, 0), 0, f_pad)
            return mesh_lib.reshard_axis(t, mesh, axis=0, src_axis=1)[:, :il]

        def to_traces(t: torch.Tensor) -> torch.Tensor:
            t = mesh_lib.reshard_axis(_pad_axis(t, 1, il_pad), mesh, axis=1,
                                      src_axis=0)
            return t[:f_kept].movedim(0, -1).contiguous()

        # stage 1: this rank's ilines to its device
        with laps.lap("stage2.upload", "upload"):
            x = mesh_lib.slice_sharding(mesh, _pad_axis(
                torch.from_numpy(data[..., :n]), 0, il_pad))
        with laps.lap("stage2.solve", "solve"):
            # time -> frequency, then all_to_all
            with timing.span("stage2.rfft"):
                spec = spectral.forward_fft(x, twt, real=real,
                                            upsample=upsample)
                del x
                z = spec.data
                if window is not None:
                    w = torch.from_numpy(window).to(device)
                    z = Cplx(z.re * w, z.im * w)
            z = Cplx(to_slices(z.re).contiguous(),
                     to_slices(z.im).contiguous())
            del spec

            # stage 2: POCS on this rank's frequency slices
            m = mesh_lib.replicated_sharding(mesh, torch.from_numpy(mask))
            rec, iters, cost = _solve_block(z, m, transform, config, batch)
            del z
            with timing.span("stage2.stats"):
                n_iters = mesh_lib.gather(mesh, iters).cpu().numpy()[:f_kept]
                costs = mesh_lib.gather(mesh, cost).cpu().numpy()[:f_kept]

            # stage 3: all_to_all back to ilines, frequency -> time
            spec = spectral.Spectrum(Cplx(to_traces(rec.re),
                                          to_traces(rec.im)),
                                     freqs, nfft, n, t0, dt, real)
            del rec
            with timing.span("stage2.irfft"):
                _, x = spectral.inverse_fft_original(spec)
                del spec
                if envelope_clip:
                    x = x.clamp(min=0.0)
                if rescale_minmax is not None:
                    # the range of the cube's ilines, the mesh's padding
                    # left out
                    rows = mesh_lib.block(mesh, il_pad)
                    valid = x[:max(0, min(il, rows.stop) - rows.start)]
                    lo, hi = _global_range(mesh, valid)
                    x = rescale(x, rescale_minmax[0], rescale_minmax[1],
                                amin=lo, amax=hi)
        with laps.lap("stage2.download", "download"):
            x = mesh_lib.gather(mesh, x)
            with timing.span("stage2.d2h", bytes=x.nbytes):
                x_host = x.cpu()
            x_host = x_host.numpy()[:il0, :xl0]

        with timing.span("stage2.host_out"):
            coords = {k: v for k, v in cube.coords.items() if k != "twt"}
            coords["twt"] = twt
            out = Cube(
                coords=coords,
                data_vars={var: (dims[:-1] + ("twt",),
                                 np.ascontiguousarray(x_host, np.float32)),
                           "fold": cube.data_vars["fold"]},
                attrs=dict(cube.attrs),
                coord_attrs={"twt": {"units": "s",
                                     "long_name": "two-way traveltime"}},
            )
            out.append_history(
                f"FFT({var})"
                + (f" {filter_type.upper()} {filter_freqs}" if filter_type
                   else "")
                + f";POCS({config.transform_kind},{config.version},"
                f"niter={config.niter},sharded-e2e);IFFT")
            out.attrs["pocs_mean_iterations"] = float(n_iters.mean())
            out.attrs["pocs_mean_cost"] = float(costs.mean())
            if out_path and mesh.index == 0:
                from ..io.ncio import write_cube

                write_cube(out_path, out)
    return out
