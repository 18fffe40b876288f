"""Step 10 — geometry & binning: many 2D profiles -> sparse 3D cube.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/binning.py``.
replaces: pseudo_3D_interpolation/cube_binning_3D.py (1764 LoC). The whole
trace->bin assignment is one vectorized pass over the headers on the host
(affine + rounding). The traces stream file by file: each block is read,
decoded and padded onto the global TWT axis on the host, uploaded once,
and stacked on the device into a running (bins, samples) accumulator
(average/IDW), best-distance-replaced (nearest), or kept on the host for
the median; the cube comes back from the device once.

Geometry config keys follow the reference's YAML
(docs/3D/cube_binning_geometry.md): extent or corner points, rotation
angle/center, bin sizes, optional TWT window, stacking method.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..io.auxiliary import resolve_input_files
from ..io.cube import Cube
from ..io.headers import scale_coordinates
from ..io.segy import SegyFile
from ..ops import binning as bn
from ..ops.affine import Affine, coords_to_ilxl_transform, points_from_extent
from ..utils.device import resolve_device
from ..utils.logging import xprint


@dataclasses.dataclass
class BinningGeometry:
    """Cube geometry (reference YAML: cube_binning_geometry).

    Optional nested region (reference cube_binning_3D.py:413-558): when the
    cube is a sub-area of a larger master grid, ``region_extent`` /
    ``region_corner_points`` + ``region_spacing`` define the fine master
    grid; line indices then live on the master grid (no longer starting at
    1) and step by ``spacing / region_spacing``, so differently binned
    cubes of one survey share index space.
    """

    spacing: tuple[float, float] | float  # (iline, xline) bin size, CRS units
    extent: tuple | None = None  # (xmin, xmax, ymin, ymax) in unrotated frame
    corner_points: np.ndarray | None = None
    rotation_angle: float | None = None  # degrees
    rotation_center: tuple[float, float] = (0.0, 0.0)
    twt_limits: tuple[float, float] | None = None  # seconds
    stacking_method: str = "average"
    idw_power: float = 1.0
    region_extent: tuple | None = None
    region_corner_points: np.ndarray | None = None
    region_spacing: tuple[float, float] | float | None = None
    # cube CRS (reference --params_spatial_ref, cube_binning_3D.py:1363,
    # :1183-1191): any parse_crs spec — EPSG int, 'EPSG:xxxx', WKT, proj
    # string. Stamped into the cube attrs (spatial_ref/epsg/
    # measurement_system); geometry math is CRS-agnostic.
    crs: object | None = None

    def crs_attrs(self) -> dict:
        """Reference-parity CRS/bin metadata for the cube attrs
        (cube_binning_3D.py:1184-1199)."""
        attrs = {}
        si, sx = self._pair(self.spacing)
        if si == sx:
            attrs["bin_size"] = si
        else:
            attrs["bin_size_iline"] = si
            attrs["bin_size_xline"] = sx
        if self.crs is None:
            return attrs
        from ..utils.crs import GEOGRAPHIC, crs_label, parse_crs

        proj = parse_crs(self.crs)  # validates the spec
        projected = proj is not GEOGRAPHIC
        attrs["measurement_system"] = "m" if projected else "deg"
        attrs["bin_units"] = "m" if projected else "deg"
        attrs["spatial_ref"] = (self.crs if isinstance(self.crs, str)
                                else crs_label(self.crs))
        label = crs_label(self.crs)
        if label.upper().startswith("EPSG:"):
            attrs["epsg"] = int(label.split(":", 1)[1])
        return attrs

    def _pair(self, s):
        return (float(s[0]), float(s[1])) if isinstance(s, (tuple, list)) else (float(s), float(s))

    def transforms(self):
        """Returns (world->ilxl transform, il_indices, xl_indices)."""
        base = None
        if self.rotation_angle is not None:
            base = Affine().rotate_around(-self.rotation_angle, self.rotation_center)
        corners = self.corner_points
        if corners is None:
            corners = points_from_extent(self.extent)
        corners = np.asarray(corners, float)

        use_region = self.region_spacing is not None and (
            self.region_extent is not None or self.region_corner_points is not None
        )
        if not use_region:
            t, n_il, n_xl = coords_to_ilxl_transform(
                corner_points=corners, spacing=self.spacing, base_transform=base
            )
            return t, np.arange(1, n_il + 1), np.arange(1, n_xl + 1)

        region_corners = self.region_corner_points
        if region_corners is None:
            region_corners = points_from_extent(self.region_extent)
        t, n_il_r, n_xl_r = coords_to_ilxl_transform(
            corner_points=np.asarray(region_corners, float),
            spacing=self.region_spacing,
            base_transform=base,
        )
        # cube corner indices on the master grid; lower bounds round up,
        # upper bounds round down (reference round_ilxl_extent)
        idx = t.transform(corners)
        il_lo = int(np.ceil(idx[:, 0].min()))
        il_hi = int(np.floor(idx[:, 0].max()))
        xl_lo = int(np.ceil(idx[:, 1].min()))
        xl_hi = int(np.floor(idx[:, 1].max()))
        # spacing tuples are (yspacing, xspacing) and ilines advance along x
        # (ops/affine.coords_to_ilxl_transform), so the iline step comes from
        # the [1] component — the reference makes the same cross-assignment
        # ("using XLINE bin size", cube_binning_3D.py:494-497)
        sy, sx = self._pair(self.spacing)
        ry, rx = self._pair(self.region_spacing)
        il_step = max(int(round(sx / rx)), 1)
        xl_step = max(int(round(sy / ry)), 1)
        il_indices = np.arange(il_lo, il_hi + 1, il_step)
        xl_indices = np.arange(xl_lo, xl_hi + 1, xl_step)
        return t, il_indices, xl_indices


def scrape_traces(files, src_coords_bytes=(73, 77), verbose=0, workers: int = 8):
    """Gather (x, y, delrt, dt_us, ns, file, trace_idx) for every trace.

    Files scrape concurrently on a host thread pool (header I/O releases
    the GIL in the kernel read path) — the analogue of the reference's
    dask.delayed header scrape (cube_binning_3D.py:624-634); order is
    preserved."""
    import concurrent.futures

    def _one(p):
        with SegyFile(p) as f:
            x, y, _ = scale_coordinates(f, src_coords_bytes)
            delrt = f.header("DelayRecordingTime").astype(np.float64) * 1e-3  # ms -> s
            row = dict(file=p, x=x, y=y, delrt=delrt, dt_us=f.dt_us, ns=f.n_samples)
        xprint(f"scraped {p}: {len(x)} traces", kind="debug", verbosity=verbose)
        return row

    if len(files) <= 1 or workers <= 1:
        return [_one(p) for p in files]
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(_one, files))


def _stack_block(acc_num, acc_den, best_dist, method, block, ids, dist,
                 idw_power):
    """Stack one padded host block of traces into the running accumulator
    on its device: ``acc_num`` (bins, samples) float32, ``acc_den`` (bins,)
    float64, ``best_dist`` (bins,) float64 for nearest. The block is
    uploaded once; the ids go up once per block."""
    dev = acc_num.device
    if method == "nearest":
        # the first trace of each bin after a sort by (bin, distance); it
        # replaces an earlier block's trace only when strictly nearer
        order = np.lexsort((dist, ids))
        ids_s = ids[order]
        first = np.ones(len(ids_s), bool)
        first[1:] = ids_s[1:] != ids_s[:-1]
        rows = order[first]
        ids_u = torch.from_numpy(ids_s[first]).to(dev)
        d_u = torch.from_numpy(dist[rows]).to(dev)
        better = d_u < best_dist[ids_u]
        win = ids_u[better]
        acc_num[win] = torch.from_numpy(block[rows]).to(dev)[better]
        best_dist[win] = d_u[better]
        acc_den[win] = 1.0
        return
    ids_t = torch.from_numpy(ids).to(dev)
    wb = torch.from_numpy(block).to(dev)
    if method == "idw":
        w = 1.0 / (dist ** idw_power + 1e-10)
        # float32 weights BEFORE the multiply, the JAX package's arithmetic;
        # the denominator sums the float64 weights
        wb = wb * torch.from_numpy(w.astype(np.float32)).to(dev)[:, None]
        acc_den.index_add_(0, ids_t, torch.from_numpy(w).to(dev))
    else:
        acc_den.index_add_(0, ids_t, torch.ones(len(ids), dtype=torch.float64,
                                                device=dev))
    acc_num.index_add_(0, ids_t, wb)


def bin_cube(
    path,
    geometry: BinningGeometry,
    out_path: str | None = None,
    fsuffix: str = "sgy",
    src_coords_bytes=(73, 77),
    trace_block: int = 65536,
    attrs_config=None,
    out_of_core: bool | None = None,
    ooc_threshold_bytes: int = 2 << 30,
    verbose: int = 0,
    device=None,
) -> Cube | str:
    """Bin all profile traces onto the (iline, xline, twt) grid.

    Traces stream in blocks: each block is delay-padded onto the global TWT
    axis on the host, uploaded, and stacked on ``device`` into a running
    (sum, weight) accumulator (average/IDW) or best-distance-replaced
    (nearest); the median keeps the padded blocks on the host and stacks
    them on ``device`` at the end, in chunks of bins that fit. Returns
    (and optionally writes) the cube with ``amp(iline, xline, twt)`` +
    ``fold``. ``device`` defaults to the first CUDA card and raises without
    one; ``device='cpu'`` runs on the host.

    Out-of-core: when the accumulator would exceed ``ooc_threshold_bytes``
    (or ``out_of_core=True``), the (bins, samples) accumulator lives in a
    disk-backed memmap next to ``out_path`` on the host, the blocks stack
    there, and the cube streams to ``out_path`` iline-block by iline-block
    (host, h5py). Requires ``out_path``; all stacking methods are
    supported: median re-reads each iline block's traces in a second pass
    and stacks the block on ``device`` (the reference's per-iline lazy
    stacking, cube_binning_3D.py:1128-1166). Returns ``out_path``.
    """
    dev = resolve_device(device)
    files = resolve_input_files(path, fsuffix)
    if not files:
        raise FileNotFoundError(f"no SEG-Y input under {path!r}")
    scrape = scrape_traces(files, src_coords_bytes, verbose)

    t, il_indices, xl_indices = geometry.transforms()
    inv = t.inverse()
    n_il, n_xl = len(il_indices), len(xl_indices)
    n_bins = n_il * n_xl

    # global TWT axis across all files
    dt = scrape[0]["dt_us"] * 1e-6
    for r in scrape:
        if r["dt_us"] * 1e-6 != dt:
            raise ValueError("all profiles must share one sample interval")
    delrt_min = min(float(r["delrt"].min()) for r in scrape)
    end_max = max(float(r["delrt"].max()) + r["ns"] * dt for r in scrape)
    if geometry.twt_limits is not None:
        twt0, twt1 = geometry.twt_limits
    else:
        twt0, twt1 = delrt_min, end_max
    ns_out = int(np.ceil((twt1 - twt0) / dt))
    ns_out += ns_out % 2  # even length for the FFT stage
    xprint(
        f"grid {n_il} il x {n_xl} xl x {ns_out} samples (twt {twt0:.3f}-{twt1:.3f}s)",
        kind="info", verbosity=verbose,
    )

    method = geometry.stacking_method
    if method not in bn.STACK_METHODS:
        raise ValueError(f"unknown stacking method {method!r}; choose one "
                         f"of {bn.STACK_METHODS}")
    est_bytes = n_bins * ns_out * 4
    ooc = bool(out_of_core) if out_of_core is not None else est_bytes > ooc_threshold_bytes
    if ooc and not out_path:
        raise ValueError("out-of-core binning requires out_path")

    # assignment pre-pass: headers only (ids, center distances, fold) — no
    # trace data touched; this is what makes the median two-pass path cheap
    fold = np.zeros((n_bins,), np.int64)
    assign = []
    for r in scrape:
        pi, px, valid = bn.assign_bins_indexed(r["x"], r["y"], t, il_indices, xl_indices)
        if not valid.any():
            continue
        ids_all = pi.astype(np.int64) * n_xl + px
        dist = bn.bin_center_distances(r["x"], r["y"], il_indices[pi],
                                       xl_indices[px], inv)
        fold += np.bincount(ids_all[valid], minlength=n_bins)
        assign.append({"r": r, "ids": ids_all, "pi": pi, "px": px,
                       "dist": dist, "valid": valid})

    median = method == "median"
    acc_num = acc_den = best_dist = None
    if not median:
        if ooc:
            import tempfile

            _mmfile = tempfile.NamedTemporaryFile(
                prefix="p3d_binacc_", suffix=".mm",
                dir=os.path.dirname(os.path.abspath(out_path)) or ".")
            acc_host = np.memmap(_mmfile.name, dtype=np.float32, mode="w+",
                                 shape=(n_bins, ns_out))
            acc_num = torch.from_numpy(acc_host)
            xprint(f"out-of-core binning: {est_bytes / 2**30:.1f} GiB accumulator "
                   f"memmapped at {_mmfile.name}", kind="info", verbosity=verbose)
        else:
            acc_num = torch.zeros((n_bins, ns_out), dtype=torch.float32,
                                  device=dev)
        acc_den = torch.zeros((n_bins,), dtype=torch.float64,
                              device=acc_num.device)
        if method == "nearest":
            # streaming best-trace-per-bin update — no trace retention
            best_dist = torch.full((n_bins,), float("inf"),
                                   dtype=torch.float64, device=acc_num.device)
    keep = median and not ooc
    kept_traces, kept_ids = [], []

    for a in ([] if median and ooc else assign):
        r, ids_all, dist, valid = a["r"], a["ids"], a["dist"], a["valid"]
        with SegyFile(r["file"]) as f:
            data = f.trace_data()
        for s in range(0, len(ids_all), trace_block):
            sl = slice(s, s + trace_block)
            v = valid[sl]
            if not v.any():
                continue
            block = bn.pad_traces_to_global_twt(
                data[sl][v], r["delrt"][sl][v], twt0, dt, ns_out)
            if keep:
                kept_traces.append(block)
                kept_ids.append(ids_all[sl][v])
            else:
                _stack_block(acc_num, acc_den, best_dist, method, block,
                             ids_all[sl][v], dist[sl][v], geometry.idw_power)

    if ooc:
        _write_out_of_core(out_path, geometry, files, method, fold, assign,
                           acc_num, acc_den, il_indices, xl_indices, twt0,
                           dt, ns_out, attrs_config, dev, verbose)
        if not median:
            del acc_num, acc_host
            _mmfile.close()
        return out_path

    if not median:
        acc_num /= torch.where(acc_den == 0, 1.0, acc_den).to(torch.float32)[:, None]
        amp = acc_num.cpu().numpy()
        del acc_num
    elif not kept_traces:
        # no trace fell inside the grid: an all-zero cube like the other
        # stacking methods
        amp = np.zeros((n_bins, ns_out), np.float32)
    else:
        amp = bn.stack_traces(np.concatenate(kept_traces),
                              np.concatenate(kept_ids), n_bins,
                              method="median", device=dev).cpu().numpy()

    amp = amp.reshape(n_il, n_xl, ns_out)
    fold = fold.reshape(n_il, n_xl).astype(np.int32)
    coverage = float((fold > 0).mean())
    xprint(f"coverage: {coverage:.1%}, max fold {fold.max()}", kind="info", verbosity=verbose)

    cube = Cube(
        coords=_coords(il_indices, xl_indices, twt0, dt, ns_out),
        data_vars={
            "amp": (("iline", "xline", "twt"), amp),
            "fold": (("iline", "xline"), fold),
        },
        attrs=_attrs(geometry, files, method, coverage),
        coord_attrs={"twt": _TWT_ATTRS},
    )
    cube.append_history(
        f"cube_binning: {len(files)} files, {method} stack, "
        f"{n_il}x{n_xl}x{ns_out}"
    )
    encodings = None
    if attrs_config is not None:
        from ..io.ncio import apply_attrs, load_attrs_config

        attrs_time, _, encodings, _ = load_attrs_config(attrs_config)
        apply_attrs(cube, attrs_time)
    if out_path:
        from ..io.ncio import write_cube

        write_cube(out_path, cube, encodings=encodings)
    return cube


_TWT_ATTRS = {"units": "s", "long_name": "two-way traveltime"}


def _coords(il_indices, xl_indices, twt0, dt, ns_out) -> dict:
    return {"iline": np.asarray(il_indices, np.int32),
            "xline": np.asarray(xl_indices, np.int32),
            "twt": (twt0 + np.arange(ns_out) * dt).astype(np.float64)}


def _attrs(geometry, files, method, coverage) -> dict:
    return {"long_name": "pseudo-3D cube",
            "description": f"binned from {len(files)} profiles",
            "bin_spacing": str(geometry.spacing),
            "stacking_method": method,
            "coverage": coverage,
            **geometry.crs_attrs()}


def _write_out_of_core(out_path, geometry, files, method, fold, assign,
                       acc_num, acc_den, il_indices, xl_indices, twt0, dt,
                       ns_out, attrs_config, dev, verbose):
    """Normalize the host accumulator (or, for the median, re-read and
    stack each iline block's traces on ``dev``) and stream the cube to
    ``out_path`` per iline block; nothing cube-sized in RAM."""
    import datetime as _dt

    from ..io.ncio import CubeWriter

    n_il, n_xl = len(il_indices), len(xl_indices)
    fold2 = fold.reshape(n_il, n_xl).astype(np.int32)
    coverage = float((fold2 > 0).mean())
    xprint(f"coverage: {coverage:.1%}, max fold {fold2.max()}",
           kind="info", verbosity=verbose)
    attrs = _attrs(geometry, files, method, coverage)
    entry = (f"cube_binning: {len(files)} files, {method} stack, "
             f"{n_il}x{n_xl}x{ns_out} (out-of-core)")
    attrs["history"] = f"{entry};"
    attrs["text"] = f"\n{_dt.date.today().isoformat()}: {entry}"
    encodings = {}
    attrs_time = {}
    if attrs_config is not None:
        from ..io.ncio import load_attrs_config

        attrs_time, _, encodings, _ = load_attrs_config(attrs_config)
        for k, a in attrs_time.items():
            if k == "cube":
                attrs.update({kk: vv for kk, vv in a.items() if kk != "history"})
    if encodings.get("amp"):
        raise ValueError("packed encodings are not supported by the "
                         "out-of-core streaming writer yet")
    with CubeWriter(out_path, _coords(il_indices, xl_indices, twt0, dt, ns_out),
                    attrs=attrs, coord_attrs={"twt": _TWT_ATTRS}) as wr:
        wr.create_var("amp", ("iline", "xline", "twt"), np.float32,
                      chunks={"iline": 1}, attrs=attrs_time.get("amp"))
        wr.create_var("fold", ("iline", "xline"), np.int32,
                      attrs=attrs_time.get("fold"))
        wr.write_slab("fold", fold2)
        il_block = max(1, (64 << 20) // max(n_xl * ns_out * 4, 1))
        if method == "median":
            # two-pass per-iline-block median: re-read only this block's
            # traces from each profile (reference stacks bins lazily per
            # iline the same way, cube_binning_3D.py:1128-1166)
            for i0 in range(0, n_il, il_block):
                i1 = min(i0 + il_block, n_il)
                nb = (i1 - i0) * n_xl
                parts, part_ids = [], []
                for a in assign:
                    sel = a["valid"] & (a["pi"] >= i0) & (a["pi"] < i1)
                    if not sel.any():
                        continue
                    idx = np.nonzero(sel)[0]
                    with SegyFile(a["r"]["file"]) as f:
                        data = f.trace_data(idx)
                    parts.append(bn.pad_traces_to_global_twt(
                        data, a["r"]["delrt"][idx], twt0, dt, ns_out))
                    part_ids.append((a["pi"][idx] - i0) * n_xl + a["px"][idx])
                if parts:
                    amp_blk = bn.stack_traces(
                        np.concatenate(parts),
                        np.concatenate(part_ids).astype(np.int64),
                        nb, method="median", device=dev).cpu().numpy()
                else:
                    amp_blk = np.zeros((nb, ns_out), np.float32)
                wr.write_slab("amp", amp_blk.reshape(i1 - i0, n_xl, ns_out),
                              dim="iline", start=i0)
        else:
            den = torch.where(acc_den == 0, 1.0, acc_den).to(
                torch.float32).numpy()
            acc = acc_num.numpy()
            for i0 in range(0, n_il, il_block):
                i1 = min(i0 + il_block, n_il)
                rows = slice(i0 * n_xl, i1 * n_xl)
                blk = acc[rows] / den[rows, None]
                wr.write_slab("amp", blk.reshape(i1 - i0, n_xl, ns_out),
                              dim="iline", start=i0)
