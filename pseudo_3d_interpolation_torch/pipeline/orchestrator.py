"""One-config pipeline orchestrator: ``p3d-torch run pipeline.yml``.

Counterpart of ``pseudo_3d_interpolation_tpu/pipeline/orchestrator.py``:
the same YAML, artifact names, datalists, ``--resume`` rule and error
messages. ``run_pipeline(..., device=None)`` hands ``device`` to every
step that computes on one (the first CUDA card by default, an error
without one, resolved before the first step runs; ``device='cpu'`` on the
host); merge, reproject, delrt-pad, segy2cube, cube2segy and qc are host
steps. PyYAML is imported only where a YAML file is read (a config path,
a ``geometry_yaml``): the card's machine has none, and there a config is
given as a dict.

Beyond-reference capability: the reference chains its 16 console scripts by
hand (shell scripts, docs/workflow.md there); here ONE declarative YAML
names the steps and their options, and artifacts chain automatically —
stage-1 outputs flow to the next step through generated datalists, stage-2
through cube paths. Every artifact lands under ``workdir``.

YAML format::

    input: survey/             # dir, SEG-Y file, or .txt datalist
    workdir: out/              # all artifacts + datalists
    steps:
      - merge: {}
      - despike: {window: [9, 5], threshold: 4.0}
      - static: {mode: amp}
      - binning: {spacing: 10.0, extent: [0, 500, 0, 500], stack: average}
      - preprocess: {balance: rms}
      - fft: {}
      - pocs: {params: pocs.yml}        # or inline parameter dict
      - ifft: {}
      - postprocess: {agc_win: 0.05}
      - cube2segy: {output: final.sgy}

Each list entry is ``{step_name: {options}}`` (or the explicit
``{step: name, ...options}``). Steps run in listed order; any subset in
any order is allowed (the reference's numbered flow is a convention, not a
constraint). Stage-2 steps accept ``output: <name>`` to control the
artifact filename (default ``NN_<step>.nc`` under ``workdir``).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.device import resolve_device
from ..utils.logging import xprint
from ..utils.yamlio import load_yaml

STAGE1_STEPS = ("merge", "reproject", "delrt-correct", "delrt-pad",
                "static", "tide", "mistie", "despike")
STAGE2_STEPS = ("segy2cube", "binning", "preprocess", "fft", "pocs",
                "ifft", "postprocess", "cube2segy", "qc")
# positional args the run loop pops per step — the ONE place both the
# config-level validation and the dispatch read from
STEP_REQUIRED_ARGS = {"reproject": ("src_epsg", "dst_epsg"),
                      "tide": ("tide_file",)}
# the steps whose entry points take ``device``
DEVICE_STEPS = ("delrt-correct", "static", "tide", "mistie", "despike",
                "binning", "preprocess", "fft", "pocs", "ifft", "postprocess")


def geometry_from_dict(g: dict):
    """Build a BinningGeometry from a config mapping (the geometry-YAML
    schema of ``p3d binning --geometry-yaml``, plus flat CLI-style keys)."""
    from .binning import BinningGeometry
    from ..utils.crs import resolve_crs_spec as _resolve_crs

    _ALIAS = {"stack": "stacking_method", "bin_size": "spacing",
              "factor_dist": "idw_power", "spatial_ref": "crs"}
    # canonicalize aliases EVERYWHERE (the caller's dict AND the YAML's own
    # keys) before merging — a YAML that spells `bin_size:` must not shadow
    # an explicit flat `spacing` override after the merge (the override used
    # to be canonicalized while the YAML was not, so the stale-spelling YAML
    # key silently won)
    g = {_ALIAS.get(k, k): v for k, v in g.items()}
    if "geometry_yaml" in g:
        base = load_yaml(g["geometry_yaml"],
                         "--geometry-yaml (geometry_yaml)") or {}
        base = {_ALIAS.get(k, k): v for k, v in base.items()}
        # flat keys override the YAML's values rather than being discarded
        base.update({k: v for k, v in g.items() if k != "geometry_yaml"})
        g = base
    spacing = g.get("spacing", 10.0)
    if isinstance(spacing, dict):
        spacing = (spacing.get("iline", 10.0), spacing.get("xline", 10.0))
    elif isinstance(spacing, (list, tuple)):
        if len(spacing) == 2:
            spacing = tuple(spacing)
        elif len(spacing) == 1:
            spacing = float(spacing[0])
        else:
            raise ValueError(
                f"spacing must be a scalar or an (iline, xline) pair, "
                f"got {list(spacing)!r}")
    rot = g.get("rotation", {}) or {}
    return BinningGeometry(
        spacing=spacing,
        extent=tuple(g["extent"]) if g.get("extent") else None,
        corner_points=(np.asarray(g["corner_points"], float)
                       if "corner_points" in g else None),
        rotation_angle=g.get("rotation_angle", rot.get("angle")),
        rotation_center=tuple(g.get("rotation_center",
                                    rot.get("center", (0.0, 0.0)))),
        twt_limits=tuple(g["twt_limits"]) if g.get("twt_limits") else None,
        stacking_method=g.get("stacking_method", "average"),
        idw_power=float(g.get("idw_power", 1.0)),
        region_extent=(tuple(g["region_extent"])
                       if g.get("region_extent") else None),
        region_corner_points=(np.asarray(g["region_corner_points"], float)
                              if g.get("region_corner_points") is not None
                              else None),
        region_spacing=g.get("region_spacing"),
        # same '@file'/.yml indirection as `p3d binning --spatial-ref` so
        # the two documented entry points accept identical specs
        crs=_resolve_crs(g.get("crs")),
    )


def _normalize_steps(steps) -> list:
    out = []
    for entry in steps:
        if not isinstance(entry, dict) or not entry:
            raise ValueError(f"each step must be a mapping, got {entry!r}")
        if "step" in entry:
            opts = dict(entry)
            name = opts.pop("step")
        elif len(entry) == 1:
            name, opts = next(iter(entry.items()))
            opts = dict(opts or {})
        else:
            raise ValueError(
                f"ambiguous step entry {entry!r}: use {{name: {{options}}}}")
        name = str(name).replace("_", "-")
        if name not in STAGE1_STEPS and name.replace("-", "_") not in [
                s.replace("-", "_") for s in STAGE2_STEPS]:
            raise ValueError(
                f"unknown step {name!r}; stage 1: {STAGE1_STEPS}, "
                f"stage 2: {STAGE2_STEPS}")
        # canonicalize option spelling to underscores HERE: the run loop
        # pops underscore keys only, so an accepted dash spelling
        # ('src-epsg') would otherwise pass validation and then crash
        # mid-pipeline with the raw KeyError validation claims to prevent
        opts = {str(k).replace("-", "_"): v for k, v in opts.items()}
        # required options fail at config level with the step named, not as
        # a raw KeyError deep in the run loop (the run loop pops exactly
        # STEP_REQUIRED_ARGS positionally — keep the two in sync there);
        # an explicit YAML null ('tide_file: ') is as missing as an absent key
        required = STEP_REQUIRED_ARGS.get(name, ())
        missing = [k for k in required if opts.get(k) is None]
        if missing:
            raise ValueError(
                f"step {name!r} is missing required option(s): "
                f"{', '.join(missing)}")
        out.append((name, opts))
    return out


def _write_datalist(paths, workdir, idx, name) -> str:
    # absolute paths: datalist lines are resolved relative to the datalist's
    # own directory by resolve_input_files, which would double a relative
    # workdir prefix
    lst = os.path.join(workdir, f"{idx:02d}_{name}.txt")
    with open(lst, "w") as f:
        f.write("\n".join(os.path.abspath(p) for p in paths) + "\n")
    return lst


def _step_done(name, idx, workdir, opts) -> str | None:
    """Existing artifact for this step, or None if it must (re)run."""
    if name in STAGE1_STEPS:
        lst = os.path.join(workdir, f"{idx:02d}_{name}.txt")
        if os.path.exists(lst):
            with open(lst) as f:
                outs = [ln.strip() for ln in f if ln.strip()]
            if outs and all(os.path.exists(p) for p in outs):
                return lst
        return None
    out = opts.get("output")
    if out is not None and not os.path.isabs(out):
        out = os.path.join(workdir, out)
    if out is None:
        stem = "cube" if name in ("binning", "cube2segy") else name
        ext = ".sgy" if name == "cube2segy" else ".nc"
        out = os.path.join(workdir, f"{idx:02d}_{stem}{ext}")
    return out if os.path.exists(out) else None


def run_pipeline(config: str | dict, verbose: int = 1,
                 resume: bool = False, device=None) -> str:
    """Run the configured step sequence; returns the final artifact path.

    ``resume=True`` skips any step whose chained artifact already exists
    under ``workdir`` (stage 1: the datalist and every file it names;
    stage 2: the output cube/SEG-Y) — the whole-pipeline analogue of the
    POCS driver's checkpoint resume. ``device`` goes to every step of
    :data:`DEVICE_STEPS`; it is resolved before the first step, so a
    missing card raises before anything runs.
    """
    if isinstance(config, str):
        cfg = load_yaml(config, "the config of p3d-torch run")
    else:
        cfg = dict(config)
    if "input" not in cfg or "steps" not in cfg:
        raise ValueError("pipeline config needs 'input' and 'steps'")
    steps = _normalize_steps(cfg["steps"])
    if any(name in DEVICE_STEPS for name, _ in steps):
        device = resolve_device(device)
    workdir = os.path.abspath(cfg.get("workdir", "p3d_pipeline"))
    os.makedirs(workdir, exist_ok=True)

    from . import stage1

    stage1_fns = {
        "merge": stage1.merge_small_files,
        "reproject": stage1.reproject,
        "delrt-correct": stage1.delrt_correct,
        "delrt-pad": stage1.delrt_pad,
        "static": stage1.static_correct,
        "tide": stage1.tide_compensate,
        "mistie": stage1.mistie_correct,
        "despike": stage1.despike,
    }

    cur = cfg["input"]
    for idx, (name, opts) in enumerate(steps, 1):
        opts = {k.replace("-", "_"): v for k, v in opts.items()}
        dev = {"device": device} if name in DEVICE_STEPS else {}
        if resume and name not in ("segy2cube", "qc"):  # side steps always run
            done = _step_done(name, idx, workdir, opts)
            if done is not None:
                xprint(f"[{idx:02d}] {name}: resume — using {done}",
                       kind="info", verbosity=verbose)
                cur = done
                continue
        xprint(f"[{idx:02d}] {name}: {opts or ''}", kind="info",
               verbosity=verbose)
        step_dir = os.path.join(workdir, f"{idx:02d}_{name}")
        if name in STAGE1_STEPS:
            os.makedirs(step_dir, exist_ok=True)
            fn = stage1_fns[name]
            args = [opts.pop(k) for k in STEP_REQUIRED_ARGS.get(name, ())]
            if name == "despike" and "window" in opts:
                opts["window"] = tuple(opts["window"])
            outs = fn(cur, *args, output_dir=step_dir, verbose=verbose,
                      **dev, **opts)
            if not outs:
                raise RuntimeError(f"step {name!r} produced no outputs")
            cur = _write_datalist(outs, workdir, idx, name)
            continue
        # ---- stage 2 ----
        out_path = opts.pop("output", None)
        if out_path is not None and not os.path.isabs(out_path):
            out_path = os.path.join(workdir, out_path)
        if name == "segy2cube":
            from .segy2cube import convert

            # honor a user 'output' as the conversion directory (popped
            # above like every stage-2 step; it was silently dropped before)
            conv_dir = out_path or step_dir
            os.makedirs(conv_dir, exist_ok=True)
            convert(cur, out_dir=conv_dir, verbose=verbose, **opts)
            continue  # side artifact: binning consumes SEG-Y directly
        if name == "binning":
            from .binning import bin_cube

            out_path = out_path or os.path.join(workdir, f"{idx:02d}_cube.nc")
            geom_keys = ("geometry_yaml", "spacing", "bin_size", "extent",
                         "corner_points", "rotation", "rotation_angle",
                         "rotation_center", "twt_limits", "stacking_method",
                         "stack", "idw_power", "factor_dist",
                         "region_extent", "region_corner_points",
                         "region_spacing", "crs", "spatial_ref")
            geom = geometry_from_dict(
                {k: opts.pop(k) for k in list(opts) if k in geom_keys})
            bin_cube(cur, geom, out_path=out_path, verbose=verbose, **dev,
                     **opts)
            cur = out_path
            continue
        if out_path is None:
            if name == "cube2segy":
                out_path = os.path.join(workdir, f"{idx:02d}_cube.sgy")
            else:
                out_path = os.path.join(workdir, f"{idx:02d}_{name}.nc")
        if name == "preprocess":
            from .preprocess import preprocess

            preprocess(cur, out_path=out_path, verbose=verbose, **dev,
                       **opts)
        elif name == "fft":
            from .fft import apply_fft

            apply_fft(cur, out_path=out_path, verbose=verbose, **dev,
                      **opts)
        elif name == "pocs":
            params = opts.pop("params", None)
            if params is not None:
                opts["config"] = params
            if "checkpoint_dir" in opts:
                # out-of-core streaming driver with per-batch resume
                from ..models import POCSConfig
                from .pocs import interpolate_checkpointed

                ckdir = opts.pop("checkpoint_dir")
                if not os.path.isabs(ckdir):
                    ckdir = os.path.join(workdir, ckdir)
                pocs_cfg = opts.pop("config", None)
                if pocs_cfg is None:  # same default as interpolate()
                    pocs_cfg = POCSConfig(
                        niter=50, thresh_op="hard",
                        thresh_model="exponential", p_min="adaptive",
                        version="fast", alpha=0.75, eps=1e-16)
                interpolate_checkpointed(cur, pocs_cfg, ckdir,
                                         out_path=out_path, verbose=verbose,
                                         **dev, **opts)
            else:
                from .pocs import interpolate

                interpolate(cur, out_path=out_path, verbose=verbose, **dev,
                            **opts)
        elif name == "ifft":
            from .ifft import apply_ifft

            apply_ifft(cur, out_path=out_path, verbose=verbose, **dev,
                       **opts)
        elif name == "postprocess":
            from .postprocess import postprocess

            postprocess(cur, out_path=out_path, verbose=verbose, **dev,
                        **opts)
        elif name == "qc":
            # side step: QC figures of the current artifact; cur unchanged
            from ..qc import plot as qclib
            from ..io.ncio import read_cube

            qc_dir = opts.pop("output_dir", None) or step_dir
            os.makedirs(qc_dir, exist_ok=True)
            cube = read_cube(cur) if isinstance(cur, str) else cur
            var = opts.pop("var", None) or cube.primary_var()
            dims, data = cube.data_vars[var]
            data = np.asarray(data)
            if np.iscomplexobj(data):
                data = np.abs(data)
            i = int(opts.pop("iline", data.shape[0] // 2))
            axis = np.asarray(cube.coords.get(
                dims[-1], np.arange(data.shape[-1])), float)
            qclib.plot_seismic_image(
                data[i].T, twt=axis, title=f"{name} iline {i}",
                path=os.path.join(qc_dir, f"qc_il{i}.png"))
            if "fold" in cube.data_vars:
                qclib.plot_fold_map(
                    cube["fold"], path=os.path.join(qc_dir, "qc_fold.png"))
            continue
        elif name == "cube2segy":
            from .export import cube_to_segy

            cube_to_segy(cur, out_path, verbose=verbose, **opts)
        cur = out_path
    xprint(f"pipeline done -> {cur}", kind="success", verbosity=verbose)
    return cur
