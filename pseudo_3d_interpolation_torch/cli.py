"""``p3d-torch`` — one CLI with subcommands for every workflow step.

Counterpart of ``pseudo_3d_interpolation_tpu/cli.py`` (``p3d``): the same
subcommands, numbered aliases, options and defaults, run as
``python -m pseudo_3d_interpolation_torch.cli <step> ...`` or
``p3d-torch <step> ...``.
replaces: the reference's 16 numbered console scripts (setup.cfg:80-97).
Numbered aliases (``01-merge`` .. ``16-cube2segy``) preserve the reference
ordering. YAML configs use the reference's key families (cube geometry,
POCS metadata).

Where the port differs:

- every subcommand but ``version`` takes ``--device``: None (the default)
  computes on the first CUDA card and raises without one, ``cpu`` runs the
  plain PyTorch versions on the host;
- ``--no-pallas`` parses and has no effect: the hand-written CUDA kernels
  are the port's only solver routes;
- ``warmup`` builds the kernels and runs one launch of the driver; there
  is no persistent compile cache to seed;
- PyYAML is imported only where a YAML file is read (``--params``,
  ``--geometry-yaml``, ``--attrs-yaml``, ``--gain`` values, ``run``'s
  config), and the resolved-arguments sidecar is written without it, so
  stage 1, ``nav`` and ``warmup`` run where PyYAML is absent (the card's
  machine). The cube subcommands read and write ``.nc`` files through
  h5py, which must be installed for them.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .utils.logging import set_verbosity, xprint
from .utils.yamlio import dump_yaml, yaml_module


def _add_common(p):
    p.add_argument("--verbose", "-V", type=int, nargs="?", default=1, const=2,
                   choices=[0, 1, 2], help="output verbosity")
    p.add_argument("--device", default=None,
                   help="torch device to compute on, e.g. 'cuda:1' or "
                        "'cpu'; default: the first CUDA card (an error "
                        "without one)")


def _bad_spacing(spacing):
    raise SystemExit(
        f"--spacing takes one value or an (iline, xline) pair, got {spacing}")


def _scalar_arg(v):
    """argparse type for SourceGroupScalar flags: 'auto', 0, or ±10^k —
    invalid values become clean usage errors instead of a traceback from
    check_coordinate_scalar after the command has started running."""
    try:
        from .io.headers import check_coordinate_scalar

        check_coordinate_scalar(v)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))
    return v if v == "auto" else int(v)


def _resolve_spatial_ref(spec):
    """--spatial-ref value -> CRS spec ('@file' / .yml indirection;
    shared implementation in utils/crs.py::resolve_crs_spec)."""
    from .utils.crs import resolve_crs_spec

    return resolve_crs_spec(spec)


def _geometry_from_args(args) -> "object":
    from .pipeline.binning import BinningGeometry
    from .pipeline.orchestrator import geometry_from_dict

    if args.geometry_yaml:
        # explicitly-set CLI flags OVERRIDE the YAML (geometry_from_dict's
        # flat-key precedence) — they used to be silently discarded
        flat = {"geometry_yaml": args.geometry_yaml}
        for key, val in (("spacing", args.spacing),
                         ("extent", args.extent),
                         ("rotation_angle", args.rotation_angle),
                         ("rotation_center", args.rotation_center),
                         ("twt_limits", args.twt_limits),
                         ("stack", args.stack),
                         ("idw_power", getattr(args, "factor_dist", None)),
                         ("crs", _resolve_spatial_ref(
                             getattr(args, "spatial_ref", None)))):
            if val is not None:
                flat[key] = list(val) if isinstance(val, (tuple, list)) else val
        return geometry_from_dict(flat)
    if args.extent is None:
        raise SystemExit("either --geometry-yaml or --extent is required")
    spacing = [10.0] if args.spacing is None else args.spacing
    return BinningGeometry(
        spacing=(tuple(spacing) if len(spacing) == 2
                 else spacing[0] if len(spacing) == 1
                 else _bad_spacing(spacing)),
        extent=tuple(args.extent),
        rotation_angle=args.rotation_angle,
        rotation_center=tuple(args.rotation_center or (0.0, 0.0)),
        twt_limits=tuple(args.twt_limits) if args.twt_limits else None,
        stacking_method=args.stack or "average",
        idw_power=(1.0 if getattr(args, "factor_dist", None) is None
                   else float(args.factor_dist)),
        crs=_resolve_spatial_ref(getattr(args, "spatial_ref", None)),
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="p3d-torch",
        description="pseudo-3D seismic interpolation workflow "
                    "(PyTorch / CUDA port)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def cmd(name, num, help_):
        p = sub.add_parser(name, aliases=[f"{num:02d}-{name}"], help=help_)
        _add_common(p)
        if 1 <= num <= 8:
            # shared stage-1 batch conventions (reference flags --suffix /
            # --filename_suffix / --txt_suffix / --output_dir on every
            # per-profile script)
            p.add_argument("--suffix", "-s", default="sgy",
                           help="file extension filter for directory inputs "
                                "(reference --suffix)")
            p.add_argument("--filename-suffix", "-fns", default=None,
                           help="basename-suffix filter for guided selection,"
                                " e.g. 'despk' (reference --filename_suffix)")
            if name != "merge":
                p.add_argument("--txt-suffix", default=None,
                               help="output filename suffix override "
                                    "(reference --txt_suffix)")
                p.add_argument("--output-dir", "-o", default=None,
                               help="directory for processed files "
                                    "(reference --output_dir)")
        return p

    # ---- stage 1 -----------------------------------------------------------
    p = cmd("merge", 1, "merge short SEG-Y files with temporally adjacent ones")
    p.add_argument("input", help="directory or datalist of SEG-Y files")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--txt-suffix", default=None,
                   help="merged-output filename suffix, default 'merged' "
                        "(reference --txt_suffix)")
    p.add_argument("--min-kb", type=float, default=100.0,
                   help="files smaller than this merge into neighbors")
    p.add_argument("--max-gap-s", type=float, default=60.0)

    p = cmd("reproject", 2, "reproject trace coordinates between CRSs")
    p.add_argument("input")
    p.add_argument("--src-epsg", "--src-crs", dest="src_epsg", required=True,
                   help="source CRS: EPSG code, 'EPSG:xxxx', WKT or proj "
                        "string, or @file containing a WKT (any pyproj-style "
                        "spec, like the reference)")
    p.add_argument("--dst-epsg", "--dst-crs", dest="dst_epsg", required=True,
                   help="destination CRS (same spellings as --src-epsg)")
    p.add_argument("--smooth-window", type=int, default=None)
    p.add_argument("--coords-bytes", type=int, nargs=2, default=(73, 77),
                   metavar=("XBYTE", "YBYTE"),
                   help="trace-header byte positions of x/y (reference "
                        "--src_coords)")
    p.add_argument("--scalar", default=-100, type=_scalar_arg,
                   help="output SourceGroupScalar: ±10^k (k 0..4), 0, or "
                        "'auto' (reference --scalar_coords; validated by "
                        "io.headers.check_coordinate_scalar)")
    p.add_argument("--dst-coords", choices=["source", "CDP", "group"],
                   default=None,
                   help="header pair to write (reference --dst_coords; "
                        "default writes source AND CDP)")
    p.add_argument("--inplace", action="store_true")

    p = cmd("delrt-correct", 3, "detect and fix wrong DelayRecordingTime values")
    p.add_argument("input")
    p.add_argument("--n-neighbors", type=int, default=3)
    p.add_argument("--win-samples", type=int, default=100)
    p.add_argument("--byte-delay", type=int, default=109,
                   help="trace-header byte of the recording delay "
                        "(reference --byte_delay; 109 = standard "
                        "DelayRecordingTime)")
    p.add_argument("--inplace", action="store_true")

    p = cmd("delrt-pad", 4, "zero-pad traces onto one global TWT axis")
    p.add_argument("input")
    p.add_argument("--byte-delay", type=int, default=109,
                   help="trace-header byte of the recording delay "
                        "(reference --byte_delay)")
    p.add_argument("--inplace", action="store_true")

    p = cmd("static", 5, "per-profile static correction from the seafloor horizon")
    p.add_argument("input")
    p.add_argument("--mode", choices=["amp", "swdep"], default="amp")
    p.add_argument("--win-samples", type=int, default=30)
    p.add_argument("--savgol-window", type=int, default=7,
                   help="horizon smoothing window (reference --win_sg)")
    p.add_argument("--nsta", type=int, default=None,
                   help="STA window, samples (reference --nsta)")
    p.add_argument("--nlta", type=int, default=None,
                   help="LTA window, samples (reference --nlta)")
    p.add_argument("--win-mad", type=int, default=None,
                   help="MAD outlier window, traces (reference --win_mad)")
    p.add_argument("--win-median", type=int, default=11,
                   help="median filter window, traces (reference --win_median)")
    p.add_argument("--limit-shift", type=int, default=12, metavar="N",
                   help="clip statics to +/- N samples ('amp' mode) / "
                        "meters ('swdep' mode) — the reference --limit_shift "
                        "semantics and default")
    p.add_argument("--n-amp-samples", type=int, default=5,
                   help="n largest amplitudes per seafloor search window "
                        "(reference --n_amp_samples)")
    p.add_argument("--limit-depressions", type=int, nargs=3,
                   default=(10, 10, 5),
                   metavar=("NPAD", "MAX_EDGES", "MAX_CENTER"),
                   help="relaxed shift clamp across seafloor depressions "
                        "(reference --limit_depressions, default on like "
                        "the reference)")
    p.add_argument("--write-seafloor2trace", action="store_true",
                   help="store picked seafloor TWT in the trace header "
                        "(bytes 237/233; amp mode only, like the reference "
                        "--write_seafloor2trace)")
    p.add_argument("--no-aux", action="store_true",
                   help="skip the .sta sidecar (reference --write_aux "
                        "default off; this repo writes it by default)")
    p.add_argument("--inplace", action="store_true")

    p = cmd("tide", 6, "tide compensation from a tide model / table")
    p.add_argument("input")
    p.add_argument("--velocity", type=float, default=1500.0,
                   help="water velocity m/s for the time shift (reference "
                        "tide_compensation_segy.py default)")
    p.add_argument("--tide-file", required=True,
                   help="CSV of UTC datetime,height_m (constant-position "
                        "series) OR a harmonic-constant atlas .nc/.h5 "
                        "(per-trace lat/lon/time spatial prediction)")
    p.add_argument("--src-epsg", type=int, default=None,
                   help="EPSG of projected trace coordinates (atlas mode)")
    p.add_argument("--constituents", "-c", nargs="+", default=None,
                   metavar="NAME",
                   help="restrict atlas synthesis to these constituents "
                        "(reference --constituents; e.g. m2 s2 n2 k2 k1 o1 "
                        "p1 q1)")
    p.add_argument("--correct-minor", action="store_true",
                   help="infer the 16 minor constituents from the majors "
                        "by admittance (reference --correct_minor)")
    p.add_argument("--coords-bytes", type=int, nargs=2, default=(73, 77),
                   metavar=("XBYTE", "YBYTE"),
                   help="header byte pair for positions: 73/77 source, "
                        "181/185 CDP, 81/85 group (reference --src_coords)")
    p.add_argument("--inplace", action="store_true")

    p = cmd("mistie", 7, "network mistie correction across line intersections")
    p.add_argument("input")
    p.add_argument("--min-correlation", "--quality-threshold",
                   dest="min_correlation", type=float, default=0.8,
                   help="cross-correlation quality cut-off "
                        "(reference --quality_threshold)")
    p.add_argument("--win-cc", type=float, nargs=2, default=None,
                   metavar=("UPPER_MS", "LOWER_MS"),
                   help="absolute-TWT limits of the correlation window "
                        "(reference --win_cc)")
    p.add_argument("--no-aux", action="store_true",
                   help="skip .mst sidecars (reference --write_aux default "
                        "off; this repo writes them by default)")
    p.add_argument("--no-qc", action="store_true",
                   help="skip the intersections QC layer "
                        "(reference --write_QC)")
    p.add_argument("--coords-origin", choices=["header", "aux"],
                   default="header",
                   help="navigation from trace headers or sidecar CSVs "
                        "(reference --coords_origin)")
    p.add_argument("--coords-path", default=None,
                   help="directory of navigation sidecars for "
                        "--coords-origin aux (reference --coords_path)")
    p.add_argument("--coords-fsuffix", default=None,
                   help="sidecar extension, default 'nav' "
                        "(reference --coords_fsuffix)")
    p.add_argument("--coords-text-suffix", default=None,
                   help="basename-suffix filter for the navigation sidecars "
                        "(reference --coords_text_suffix)")
    p.add_argument("--inplace", action="store_true")

    p = cmd("despike", 8, "remove noise bursts from single traces")
    p.add_argument("input")
    p.add_argument("--window", type=int, nargs=2, default=(9, 5),
                   metavar=("NSAMPLES", "NTRACES"))
    p.add_argument("--window-time", type=float, default=None, metavar="MS",
                   help="sample-axis window in TWT ms, overrides the window "
                        "sample count per file (reference --window_time)")
    p.add_argument("--threshold", type=float, default=4.0)
    p.add_argument("--mode", choices=["median", "mean", "rms"], default="median")
    p.add_argument("--replace",
                   choices=["median", "zeros", "threshold", "scaled", "mode"],
                   default="median",
                   help="spike replacement value (reference --out_amplitude)")
    p.add_argument("--split-at-delrt", action="store_true",
                   help="despike constant-delrt segments separately "
                        "(reference --use_delay)")
    p.add_argument("--byte-delay", type=int, default=109,
                   help="trace-header byte of the recording delay for "
                        "--split-at-delrt (reference --byte_delay)")
    p.add_argument("--inplace", action="store_true")

    # ---- stage 2 -----------------------------------------------------------
    p = cmd("segy2cube", 9, "convert SEG-Y profiles to per-profile netCDF")
    p.add_argument("input")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--suffix", "-s", default="sgy",
                   help="file extension filter for directory inputs "
                        "(reference --suffix)")
    p.add_argument("--filename-suffix", "-fns", default=None,
                   help="basename-suffix filter "
                        "(reference --filename_suffix)")
    p.add_argument("--workers", type=int, default=4,
                   help="parallel conversions (reference --nprocesses)")

    p = cmd("binning", 10, "bin traces onto the 3D (iline, xline, twt) grid")
    p.add_argument("input")
    p.add_argument("output", help="output cube file (.nc)")
    p.add_argument("--geometry-yaml", default=None)
    p.add_argument("--extent", type=float, nargs=4, default=None,
                   metavar=("XMIN", "XMAX", "YMIN", "YMAX"))
    # geometry flags default to None so _geometry_from_args can tell an
    # explicit value (which must override --geometry-yaml) from an absent
    # one; fallbacks applied there
    p.add_argument("--spacing", type=float, nargs="+", default=None)
    p.add_argument("--rotation-angle", type=float, default=None)
    p.add_argument("--rotation-center", type=float, nargs=2, default=None)
    p.add_argument("--twt-limits", type=float, nargs=2, default=None)
    p.add_argument("--stack", default=None,
                   choices=["average", "mean", "median", "nearest", "idw"])
    p.add_argument("--factor-dist", type=float, default=None,
                   help="IDW distance exponent for --stack idw "
                        "(reference --factor_dist, cube_binning_3D.py)")
    p.add_argument("--spatial-ref", default=None,
                   help="cube CRS stamped into the output attrs "
                        "(spatial_ref/epsg/measurement_system): EPSG code, "
                        "'EPSG:xxxx', WKT/proj string, @file, or a YAML "
                        "containing the WKT (reference --params_spatial_ref)")
    p.add_argument("--attrs-yaml", default=None,
                   help="netCDF attrs/encodings YAML (reference format: "
                        "attrs_time/attrs_freq/encodings families)")
    p.add_argument("--out-of-core", action="store_true", default=None,
                   help="stream the cube through a disk-backed accumulator "
                        "(auto-enabled when the grid exceeds ~2 GiB)")

    p = cmd("preprocess", 11, "balance/gain/filter/resample/envelope the cube")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--balance", choices=["rms", "max"], default=None)
    p.add_argument("--gain", nargs="*", default=None,
                   help="sugain key=value pairs, e.g. tpow=2 agc_=True")
    p.add_argument("--filter", dest="filter_type",
                   choices=["lowpass", "highpass", "bandpass"], default=None)
    p.add_argument("--filter-freqs", type=float, nargs="+", default=None)
    p.add_argument("--resample-to", type=int, default=None,
                   help="output sample count")
    p.add_argument("--resample-interval", type=float, default=None,
                   metavar="MS", help="output sampling interval in ms "
                   "(reference --resampling_interval)")
    p.add_argument("--resample-frequency", type=float, default=None,
                   metavar="HZ", help="output sampling rate in Hz "
                   "(reference --resampling_frequency)")
    p.add_argument("--resample-factor", type=float, default=None,
                   help="<1 upsamples, >1 downsamples "
                        "(reference --resampling_factor)")
    p.add_argument("--resample-function", default="fft",
                   choices=["fft", "poly"],
                   help="device FFT resampling or scipy polyphase "
                        "(reference --resampling_function "
                        "resample/resample_poly)")
    p.add_argument("--no-store-ref-amp", action="store_true",
                   help="skip the amp_ref balance variable "
                        "(reference --store_ref_amp default off; this repo "
                        "stores it by default)")
    p.add_argument("--use-samples", action="store_true",
                   help="gain over sample index instead of TWT "
                        "(reference --use_samples)")
    p.add_argument("--window-resample", default="hann",
                   help="polyphase FIR window for --resample-function poly "
                        "(reference --window_resample)")
    p.add_argument("--attrs-yaml", default=None,
                   help="netCDF attrs/encodings YAML, attrs_time family "
                        "(reference --params_netcdf)")
    p.add_argument("--envelope", action="store_true")
    p.add_argument("--out-of-core", action="store_true", default=None,
                   help="stream iline slabs with bounded memory "
                        "(auto-enabled when the cube exceeds ~2 GiB)")

    p = cmd("fft", 12, "forward FFT along the time axis")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--var", default=None)
    p.add_argument("--no-real", action="store_true", help="full complex FFT")
    p.add_argument("--upsampling-factor", type=int, default=1)
    p.add_argument("--filter", dest="filter_type",
                   choices=["lowpass", "highpass", "bandpass"], default=None)
    p.add_argument("--filter-freqs", type=float, nargs="+", default=None)
    p.add_argument("--drop-filtered-freq", action="store_true")
    p.add_argument("--attrs-yaml", default=None,
                   help="netCDF attrs/encodings YAML (attrs_freq family)")

    p = cmd("pocs", 13, "POCS interpolation of every frequency slice")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--params", default=None, help="POCS parameter YAML (reference format)")
    # None defaults: an explicitly passed flag must override --params
    p.add_argument("--niter", type=int, default=None)
    p.add_argument("--transform", default=None,
                   choices=["FFT", "DCT", "WAVELET", "SHEARLET", "CURVELET"])
    p.add_argument("--version", default=None, choices=["regular", "fast", "adaptive"])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--runtime-csv", default=None)
    p.add_argument("--checkpoint-dir", default=None,
                   help="write per-batch slice files here and resume from them")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (Chrome trace, "
                        "interpolate_trace.json)")
    p.add_argument("--no-pallas", action="store_true",
                   help="no effect in the port (accepted so that the JAX "
                        "package's command lines parse): the CUDA kernels "
                        "are its only solver routes")
    p.add_argument("--eps", type=float, default=None,
                   help="relative-cost convergence tolerance (reference "
                        "metadata eps; default 0.0 = run all niter exactly "
                        "— loose eps measured not quality-safe, docs/perf.md "
                        "round 4d)")
    p.add_argument("--pad-to-tile", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="zero-pad slices to %%128 sides before the solve "
                        "(observed-zero frame, cropped after) so non-"
                        "128-multiple survey grids ride the fused kernels; "
                        "default: auto — engage when the measured policy "
                        "says the padded kernel wins (pad-area <= 1.3x)")

    p = cmd("ifft", 14, "inverse FFT back to the time domain")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--var", default=None)
    p.add_argument("--envelope-clip", action="store_true")
    p.add_argument("--rescale-envelope", action="store_true",
                   help="clip negatives and rescale to [0, 1] "
                        "(reference --rescale-envelope)")
    p.add_argument("--attrs-yaml", default=None,
                   help="netCDF attrs/encodings YAML, attrs_time family "
                        "(reference --params_netcdf)")

    p = cmd("postprocess", 15, "upsample/footprint-removal/smoothing/AGC")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--upsample", nargs="?", const="linear", default=None,
                   choices=["linear", "nearest", "slinear", "cubic",
                            "polynomial"],
                   help="upsample to EQUAL bin size along ilines/xlines, "
                        "factors derived from the cube's bin_size attrs; "
                        "the optional value is the interpolation method "
                        "(reference --upsample)")
    p.add_argument("--upsample-iline", type=int, default=1)
    p.add_argument("--upsample-xline", type=int, default=1)
    p.add_argument("--upsample-method", default=None,
                   choices=["linear", "nearest", "slinear", "cubic",
                            "polynomial"],
                   help="interpolation for the refined grid, default "
                        "linear (reference --upsample)")
    p.add_argument("--no-spatial-dealiasing", action="store_true",
                   help="skip the kx-ky anti-alias filter after uneven "
                        "upsampling (reference --spatial-dealiasing, "
                        "applied automatically here)")
    p.add_argument("--remove-footprint", action="store_true",
                   help="kx-ky acquisition-footprint notch "
                        "(reference --remove-footprint)")
    p.add_argument("--footprint-sigma", type=int, default=None,
                   help="Gaussian sigma of the footprint filter; implies "
                        "--remove-footprint (reference --footprint-sigma 7)")
    p.add_argument("--footprint-direction", default="both",
                   choices=["both", "iline", "xline"],
                   help="notch direction (reference --direction)")
    # the reference's CLI default (0.20) intentionally differs from its
    # library default (0.25) — cube_postprocessing_3D.py:57 vs :183; both
    # are mirrored here (pipeline/postprocess.py keeps 0.25)
    p.add_argument("--buffer-center", type=float, default=0.20,
                   help="kx-ky center buffer fraction "
                        "(reference --buffer-center)")
    p.add_argument("--buffer-filter", type=int, default=3,
                   help="notch half-width in grid cells "
                        "(reference --buffer-filter)")
    p.add_argument("--smooth", choices=["gaussian", "median"], default=None)
    p.add_argument("--smooth-sigma", type=float, default=1.0)
    p.add_argument("--smooth-size", type=int, default=3,
                   help="median kernel size (reference --smooth-size)")
    p.add_argument("--rescale", type=float, nargs="*", default=None,
                   metavar="PERC",
                   help="percentile range for post-smooth rescale; bare "
                        "flag = 0.01 99.99 (reference --rescale)")
    p.add_argument("--agc-win", type=float, default=None)
    p.add_argument("--agc-kind", default="rms",
                   choices=["rms", "mean", "median"],
                   help="AGC statistic (reference --agc-kind)")
    p.add_argument("--out-of-core", action="store_true", default=None,
                   help="stream the chain through bounded-memory passes "
                        "(auto-enabled when the upsampled cube exceeds "
                        "~2 GiB; reference ran this step under a dask "
                        "client, cube_postprocessing_3D.py:707-711)")
    p.add_argument("--agc-sqrt", action="store_true",
                   help="squared AGC, enhances strong amplitudes "
                        "(reference --agc-sqrt)")

    p = cmd("cube2segy", 16, "export the cube to SEG-Y")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--var", default=None)
    p.add_argument("--format", type=int, default=5, choices=[1, 5])
    p.add_argument("--scalar-coords", default=-100, type=_scalar_arg,
                   help="SourceGroupScalar for exported coordinates: ±10^k "
                        "(k 0..4), 0, or 'auto' (reference --scalar_coords)")

    p = sub.add_parser("qc", help="write QC figures for a SEG-Y profile or cube")
    _add_common(p)
    p.add_argument("input", help=".sgy profile or .nc cube")
    p.add_argument("--output-dir", default="qc")
    p.add_argument("--iline", type=int, default=None,
                   help="cube: iline section to image (default: middle)")
    p.add_argument("--compare", default=None, metavar="OTHER",
                   help="second cube (.nc): adds before/after/difference "
                        "panels of the shared iline (e.g. sparse vs "
                        "interpolated)")

    p = sub.add_parser("nav", help="extract navigation from SEG-Y headers")
    _add_common(p)
    p.add_argument("input")
    p.add_argument("output", help=".csv or .geojson path")
    p.add_argument("--write-sidecars", action="store_true",
                   help="also write a .nav next to every profile")

    p = sub.add_parser("run", help="run a whole pipeline from one YAML "
                                    "(steps + options; see docs/workflow.md)")
    _add_common(p)
    p.add_argument("config", help="pipeline YAML: input, workdir, steps")
    p.add_argument("--resume", action="store_true",
                   help="skip steps whose artifacts already exist in workdir")

    p = sub.add_parser("warmup", help="build the kernels and run one "
                                      "launch of the POCS driver "
                                      "(cold-start fix)")
    _add_common(p)
    p.add_argument("--params", default=None,
                   help="POCS parameter YAML (reference format); default = "
                        "the p3d-torch pocs defaults for --transform")
    p.add_argument("--transform", default=None,
                   choices=["FFT", "DCT", "WAVELET", "SHEARLET", "CURVELET"],
                   help="basis when no --params YAML is given — the SAME "
                        "default as `p3d-torch pocs`; pass SHEARLET etc. to "
                        "build and run a directional production run's "
                        "kernels")
    p.add_argument("--niter", type=int, default=None)
    p.add_argument("--version", dest="pocs_version", default=None,
                   choices=["regular", "fast", "adaptive"],
                   help="solver version to run (match the production "
                        "run)")
    p.add_argument("--shape", type=int, nargs=2, default=(512, 512),
                   metavar=("ILINES", "XLINES"),
                   help="production slice shape, or use --like")
    p.add_argument("--like", default=None, metavar="CUBE",
                   help="read the slice shape AND slice count from this "
                        "cube (.nc) instead")
    p.add_argument("--slices", type=int, default=None,
                   help="production cube's frequency-slice count — it "
                        "decides the driver (resident or host-chunked) the "
                        "production run takes; default one batch (--like "
                        "fills it automatically)")
    p.add_argument("--batch", type=int, default=64,
                   help="slices per dispatch (match the production run)")
    p.add_argument("--no-pallas", action="store_true",
                   help="no effect in the port (accepted so that the JAX "
                        "package's command lines parse)")
    p.add_argument("--pad-to-tile", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="match a production run that pads slices to %%128 "
                        "sides; default: the same auto policy the "
                        "production drivers use")

    sub.add_parser("version", help="print version")
    return ap


def _cube_amplitude(cube, name: str):
    """Amplitude array of a cube's primary data variable (|.| if complex)."""
    try:
        var = cube.primary_var()
    except ValueError as e:
        raise SystemExit(f"{name}: {e}")
    data = np.asarray(cube[var])
    return np.abs(data) if np.iscomplexobj(data) else data


def _parse_kv(pairs):
    out = {}
    if not pairs:
        return out
    yaml = yaml_module("--gain")
    for kv in pairs:
        k, _, v = kv.partition("=")
        try:
            out[k] = yaml.safe_load(v)
        except yaml.YAMLError:
            out[k] = v
    return out


def _pocs_config_from_args(args, version: str):
    """The ONE place the p3d-torch default POCS config is built — `pocs`
    and `warmup` must produce equal configs, or warmup builds and runs
    another route than the production run takes. ``--no-pallas`` sets
    nothing: the port's POCSConfig has no ``use_pallas`` (a ``--params``
    YAML that holds it goes through ``config_from_yaml``, which drops
    it)."""
    from .models.pocs import POCSConfig
    from .utils.yamlio import load_yaml

    if args.params:
        # explicitly passed flags OVERRIDE the YAML (the repo-wide
        # CLI-overrides-YAML precedence). Overrides merge into the
        # YAML's metadata so transform kwargs (n_scales, wavelet, ...) in
        # the extra section survive.
        cfg = load_yaml(args.params, "--params")
        meta = cfg.setdefault("metadata", {k: v for k, v in cfg.items()})
        if args.niter is not None:
            meta["niter"] = args.niter
        if args.transform is not None:
            meta["transform_kind"] = args.transform
        if version is not None:
            meta["version"] = version
        if getattr(args, "pad_to_tile", None) is not None:
            meta["pad_to_tile"] = bool(args.pad_to_tile)
        if getattr(args, "eps", None) is not None:
            meta["eps"] = args.eps
        return cfg
    transform = args.transform or "FFT"
    return POCSConfig(
        niter=50 if args.niter is None else args.niter,
        thresh_op="hard", thresh_model="exponential",
        p_min="adaptive" if transform in ("FFT", "DCT", "SHEARLET") else 1e-3,
        # eps=0.0 (never stop), not the reference's 1e-16: the chosen
        # default runs all niter iterations — measured quality-safe at cube
        # scale where every loose eps criterion loses dB (docs/perf.md
        # round 4d) — and is the only value eligible for the fused folded
        # kernel (models/pocs.py gate). Not strictly identical to 1e-16
        # (a cost = (Σ(|x|-|x_old|))²/(Σ|x|)² lands below 1e-16 whenever
        # the relative signed sum is under 1e-8, representable in f32),
        # but such near-converged slices only run extra decaying-threshold
        # iterations. YAML/--eps override.
        version=version or "fast", alpha=0.75,
        eps=0.0 if getattr(args, "eps", None) is None else args.eps,
        transform_kind=transform,
        pad_to_tile=getattr(args, "pad_to_tile", None),
    )


def _dump_resolved_args(cmd: str, args, verbosity: int) -> str | None:
    """Reproducibility sidecar: after a successful run, every subcommand
    writes its RESOLVED arguments (post-parse, incl. YAML-merged and
    in-dispatch-normalized values) as a timestamped YAML next to its
    outputs — the reference writes the same artifact per script
    (despiking_2D_segy.py:528-533). Gated on verbosity >= 1 like the
    reference. The YAML is written by ``utils.yamlio.dump_yaml``, not
    PyYAML, so the sidecar is written where PyYAML is absent;
    ``yaml.safe_load`` reads it back to the values ``yaml.safe_dump``
    would have written."""
    if cmd == "version" or verbosity < 1:
        return None
    target = None
    out = getattr(args, "output", None)
    if isinstance(out, str) and out:
        target = os.path.dirname(os.path.abspath(out))
    elif getattr(args, "output_dir", None):
        target = args.output_dir
    else:
        inp = (getattr(args, "input", None) or getattr(args, "config", None)
               or getattr(args, "like", None))
        if isinstance(inp, (list, tuple)):
            inp = inp[0] if inp else None
        if isinstance(inp, str):
            target = (inp if os.path.isdir(inp)
                      else os.path.dirname(os.path.abspath(inp)))
    if not target or not os.path.isdir(target):
        return None

    def _clean(v):
        if isinstance(v, bool) or v is None:
            return v
        if isinstance(v, (str, int, float)):
            return v
        if isinstance(v, (list, tuple, set)):
            return [_clean(x) for x in v]
        if isinstance(v, dict):
            return {str(k): _clean(x) for k, x in v.items()}
        if isinstance(v, np.generic):
            return v.item()
        return str(v)

    import datetime as _dt

    # microseconds + pid in the name: two runs of the same subcommand into
    # one directory within a second must not clobber each other's record
    ts = (_dt.datetime.now().isoformat(timespec="microseconds")
          .replace(":", "").replace(".", ""))
    path = os.path.join(
        target, f"{ts}_p{os.getpid()}_p3d_{cmd}_argparse_parameter.yml")
    try:
        with open(path, "w", newline="\n") as f:
            f.write(dump_yaml({"command": cmd,
                               "args": {k: _clean(v)
                                        for k, v in vars(args).items()
                                        if k != "cmd"}}))
    except OSError as e:
        # best-effort reproducibility artifact: an unwritable target (e.g.
        # read-only input mount) must not fail a command that succeeded
        xprint(f"could not save resolved-arguments sidecar ({e})",
               kind="warning", verbosity=verbosity)
        return None
    xprint(f"saved resolved arguments -> {path}", kind="debug",
           verbosity=verbosity)
    return path


def main(argv=None) -> int:
    """Run one subcommand; returns its exit code. Every callee that takes
    ``device`` gets ``--device``."""
    args = build_parser().parse_args(argv)
    cmd = args.cmd.split("-", 1)[-1] if args.cmd[:2].isdigit() else args.cmd
    if cmd == "version":
        from . import __version__

        print(__version__)
        return 0
    set_verbosity(getattr(args, "verbose", 1))
    v = getattr(args, "verbose", 1)
    dev = args.device
    if getattr(args, "attrs_yaml", None):
        yaml_module("--attrs-yaml")

    if cmd == "segy2cube":
        from .pipeline.segy2cube import convert

        outs = convert(args.input, out_dir=args.output_dir,
                       fsuffix=args.suffix, fnsuffix=args.filename_suffix,
                       workers=args.workers, verbose=v)
        xprint(f"converted {len(outs)} profiles", kind="success", verbosity=v)
    elif cmd == "binning":
        from .pipeline.binning import bin_cube

        bin_cube(args.input, _geometry_from_args(args), out_path=args.output,
                 attrs_config=args.attrs_yaml, out_of_core=args.out_of_core,
                 verbose=v, device=dev)
        xprint(f"wrote {args.output}", kind="success", verbosity=v)
    elif cmd == "preprocess":
        from .pipeline.preprocess import preprocess

        preprocess(args.input, balance=args.balance,
                   balance_store_ref=not args.no_store_ref_amp,
                   gain_args=_parse_kv(args.gain) or None,
                   gain_use_samples=args.use_samples,
                   filter_type=args.filter_type, filter_freqs=args.filter_freqs,
                   resample_to=args.resample_to,
                   resample_interval_ms=args.resample_interval,
                   resample_frequency_hz=args.resample_frequency,
                   resample_factor=args.resample_factor,
                   resample_method="poly" if args.resample_function == "poly" else "fft",
                   resample_window=args.window_resample,
                   envelope=args.envelope, attrs_config=args.attrs_yaml,
                   out_path=args.output, out_of_core=args.out_of_core,
                   verbose=v, device=dev)
        xprint(f"wrote {args.output}", kind="success", verbosity=v)
    elif cmd == "fft":
        from .pipeline.fft import apply_fft

        apply_fft(args.input, var=args.var, real=not args.no_real,
                  upsample=args.upsampling_factor, filter_type=args.filter_type,
                  filter_freqs=args.filter_freqs, drop_filtered=args.drop_filtered_freq,
                  out_path=args.output, attrs_config=args.attrs_yaml, verbose=v,
                  device=dev)
        xprint(f"wrote {args.output}", kind="success", verbosity=v)
    elif cmd == "pocs":
        from .pipeline.pocs import interpolate, interpolate_checkpointed

        cfg = _pocs_config_from_args(args, args.version)
        if args.checkpoint_dir:
            if args.profile_dir:
                xprint("--profile-dir is not supported with "
                       "--checkpoint-dir (per-batch launches); ignored",
                       kind="warning", verbosity=v)
            interpolate_checkpointed(args.input, cfg, args.checkpoint_dir,
                                     batch=args.batch, out_path=args.output,
                                     runtime_csv=args.runtime_csv,
                                     verbose=v, device=dev)
        else:
            interpolate(args.input, cfg, batch=args.batch, out_path=args.output,
                        runtime_csv=args.runtime_csv,
                        profile_dir=args.profile_dir, verbose=v, device=dev)
        xprint(f"wrote {args.output}", kind="success", verbosity=v)
    elif cmd == "qc":
        from . import qc as qclib

        os.makedirs(args.output_dir, exist_ok=True)
        written = []
        if args.input.lower().endswith((".sgy", ".segy")):
            if args.compare:
                raise SystemExit("--compare works on cube (.nc) inputs")
            from .io.segy import SegyFile

            with SegyFile(args.input) as f:
                data = f.trace_data().T
                twt = (f.header("DelayRecordingTime")[0] / 1e3
                       + np.arange(f.n_samples) * f.dt_us * 1e-6)
                fs = 1e6 / f.dt_us
            base = os.path.splitext(os.path.basename(args.input))[0]
            written.append(qclib.plot_seismic_image(
                data, twt=twt, title=base,
                path=os.path.join(args.output_dir, f"{base}_image.png")))
            written.append(qclib.plot_seismic_wiggle(
                data, twt=twt, title=base,
                path=os.path.join(args.output_dir, f"{base}_wiggle.png")))
            written.append(qclib.plot_average_freq_spectrum(
                data.T, fs=fs, n_traces=50,
                path=os.path.join(args.output_dir, f"{base}_spectrum_avg.png"),
                device=dev))
            sel = np.linspace(0, data.shape[1] - 1, min(4, data.shape[1])).astype(int)
            written.append(qclib.plot_trace_freq_spectrum(
                data.T[sel], fs=fs, trace_labels=[f"trace {s}" for s in sel],
                path=os.path.join(args.output_dir, f"{base}_spectrum_traces.png"),
                device=dev))
        else:
            from .io.ncio import read_cube

            cube = read_cube(args.input)
            base = os.path.splitext(os.path.basename(args.input))[0]
            data = _cube_amplitude(cube, args.input)
            i = args.iline if args.iline is not None else data.shape[0] // 2
            # no 'twt' coord (e.g. a frequency-domain cube): pass None so
            # the plotters label the axis 'sample' — an index array passed
            # as twt= would be mislabeled 'TWT (s)'
            twt = (np.asarray(cube.coords["twt"])
                   if "twt" in cube.coords else None)
            written.append(qclib.plot_seismic_image(
                data[i].T, twt=twt, title=f"{base} iline {i}",
                path=os.path.join(args.output_dir, f"{base}_il{i}.png")))
            if data.shape[0] > 1:
                written.append(qclib.plot_iline_grid(
                    data, twt=twt, title=base,
                    path=os.path.join(args.output_dir, f"{base}_iline_grid.png")))
            if "fold" in cube.data_vars:
                written.append(qclib.plot_fold_map(
                    cube["fold"], path=os.path.join(args.output_dir, f"{base}_fold.png")))
            if args.compare:
                other = read_cube(args.compare)
                d2 = _cube_amplitude(other, args.compare)
                if d2.shape != data.shape:
                    raise SystemExit(
                        f"--compare shapes differ: {d2.shape} vs {data.shape}")
                base2 = os.path.splitext(os.path.basename(args.compare))[0]
                written.append(qclib.plot_seismic_difference(
                    data[i].T, d2[i].T, twt=twt, titles=(base, base2),
                    path=os.path.join(args.output_dir,
                                      f"{base}_vs_{base2}_il{i}.png")))
                written.append(qclib.plot_seismic_wiggle_diff(
                    data[i].T, d2[i].T, twt=twt, titles=(base, base2),
                    path=os.path.join(args.output_dir,
                                      f"{base}_vs_{base2}_il{i}_wiggle.png")))
        xprint(f"wrote {len(written)} QC figures -> {args.output_dir}/",
               kind="success", verbosity=v)
    elif cmd == "run":
        from .pipeline.orchestrator import run_pipeline

        final = run_pipeline(args.config, verbose=v, resume=args.resume,
                             device=dev)
        xprint(f"final artifact: {final}", kind="success", verbosity=v)
    elif cmd == "warmup":
        from .pipeline.pocs import warmup

        shape = tuple(args.shape)
        n_slices = args.slices
        if args.like:
            from .io.ncio import CubeFile

            with CubeFile(args.like) as cf:
                dims = cf.dims_of(cf.primary_var())
                shape = (len(cf.coords[dims[0]]), len(cf.coords[dims[1]]))
                if n_slices is None:  # slice axis is last (il, xl, freq/twt)
                    n_slices = len(cf.coords[dims[-1]])
        cfg = _pocs_config_from_args(args, args.pocs_version)
        warmup(cfg, shape, batch=args.batch, verbose=v, n_slices=n_slices,
               device=dev)
    elif cmd == "nav":
        from .io.auxiliary import export_coords, navigation_table, table_rows

        table = navigation_table(args.input,
                                 write_sidecars=args.write_sidecars)
        export_coords(table, args.output)
        xprint(f"wrote {args.output} ({table_rows(table)} traces)",
               kind="success", verbosity=v)
    elif cmd == "ifft":
        from .pipeline.ifft import apply_ifft

        apply_ifft(args.input, var=args.var,
                   envelope_clip=args.envelope_clip or args.rescale_envelope,
                   rescale_minmax=(0.0, 1.0) if args.rescale_envelope else None,
                   attrs_config=args.attrs_yaml,
                   out_path=args.output, verbose=v, device=dev)
        xprint(f"wrote {args.output}", kind="success", verbosity=v)
    elif cmd == "postprocess":
        from .pipeline.postprocess import postprocess

        if args.upsample is not None:
            if args.upsample_iline != 1 or args.upsample_xline != 1:
                raise SystemExit("--upsample (auto equal-bin) and explicit "
                                 "--upsample-iline/--upsample-xline are "
                                 "mutually exclusive")
            up = "auto"
            # --upsample's optional value IS a method; an explicit
            # --upsample-method must not be silently discarded
            if args.upsample_method is None:
                args.upsample_method = args.upsample
            elif args.upsample not in ("linear", args.upsample_method):
                raise SystemExit(
                    f"--upsample {args.upsample} and --upsample-method "
                    f"{args.upsample_method} disagree — pass just one")
        else:
            up = {"iline": args.upsample_iline, "xline": args.upsample_xline}
        args.upsample_method = args.upsample_method or "linear"
        footprint = None
        if args.remove_footprint or args.footprint_sigma is not None:
            footprint = {"sigma": args.footprint_sigma or 7,
                         "direction": args.footprint_direction,
                         "buffer_center": args.buffer_center,
                         "buffer_filter": args.buffer_filter}
        rescale_p = args.rescale
        if rescale_p is not None and len(rescale_p) == 0:
            rescale_p = [0.01, 99.99]  # reference bare-flag default
        if rescale_p is not None and not args.smooth:
            # same coupling as the reference (its rescale lives inside the
            # `if args.smooth:` block, cube_postprocessing_3D.py:631-642) —
            # but warn instead of silently ignoring the flag
            xprint("--rescale only applies together with --smooth "
                   "(reference behavior); ignoring it", kind="warning",
                   verbosity=v)
        smoothing = None
        if args.smooth == "gaussian":
            smoothing = {"kind": "gaussian", "sigma": args.smooth_sigma,
                         "rescale_percentiles": rescale_p}
        elif args.smooth:
            smoothing = {"kind": "median", "size": args.smooth_size,
                         "rescale_percentiles": rescale_p}
        postprocess(
            args.input,
            upsample_factors=(up if up == "auto"
                              else up if max(up.values()) > 1 else None),
            upsample_method=args.upsample_method,
            antialias=not args.no_spatial_dealiasing,
            footprint=footprint,
            smoothing=smoothing,
            agc_win=args.agc_win, agc_kind=args.agc_kind,
            agc_sqrt=args.agc_sqrt,
            out_path=args.output, out_of_core=args.out_of_core, verbose=v,
            device=dev,
        )
        xprint(f"wrote {args.output}", kind="success", verbosity=v)
    elif cmd == "cube2segy":
        from .pipeline.export import cube_to_segy

        cube_to_segy(args.input, args.output, var=args.var, fmt=args.format,
                     coordinate_scalar=args.scalar_coords, verbose=v)
        xprint(f"wrote {args.output}", kind="success", verbosity=v)
    elif cmd in ("merge", "reproject", "delrt-correct", "delrt-pad", "static",
                 "tide", "mistie", "despike"):
        from .pipeline import stage1

        rc = stage1.run_cli(cmd, args, verbose=v)
        if not rc:
            _dump_resolved_args(cmd, args, v)
        return rc
    else:
        raise SystemExit(f"unknown command {cmd!r}")
    _dump_resolved_args(cmd, args, v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
