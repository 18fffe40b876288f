"""The port's one-config orchestrator (``p3d-torch run``,
``pipeline/orchestrator.run_pipeline``) against the JAX package's: the
config forms and their errors, the geometry mapping, and the whole
workflow of ``examples/pipeline.yml`` at a small grid through both
packages, with the same artifacts in ``workdir``, the same contents
within the steps' tolerances, and ``--resume`` skipping the same steps.
The port runs with ``device='cpu'``.

Tolerances, against ``max|JAX|``: stage 1's SEG-Y files byte for byte;
the binned cube within 1e-6 (test_torch_binning.py); preprocess and fft
within 1e-5 (test_torch_stage2.py); POCS (soft threshold) and every
later step within ``CHAIN_TOL`` = 1e-4, the chain tolerance of
test_torch_stage2.py; the final SEG-Y's headers byte for byte and its
samples within ``CHAIN_TOL``."""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

from pseudo_3d_interpolation_tpu.io.ncio import read_cube as jread_cube
from pseudo_3d_interpolation_tpu.pipeline import orchestrator as jorch
from pseudo_3d_interpolation_torch import cli
from pseudo_3d_interpolation_torch.io.auxiliary import navigation_table
from pseudo_3d_interpolation_torch.io.ncio import read_cube
from pseudo_3d_interpolation_torch.io.segy import SegyFile
from pseudo_3d_interpolation_torch.pipeline.orchestrator import (
    _normalize_steps, geometry_from_dict, run_pipeline)
from pseudo_3d_interpolation_torch.utils.crs import transform as crs_transform
from torch_helpers import (make_profile, same_csv, stage1_pipeline_steps,
                           write_stage1_survey)

torch.set_num_threads(2)

CPU = "cpu"
CHAIN_TOL = 1e-4
EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "pipeline.yml")


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ---------------------------------------------------------------------------
# the config forms (the JAX package's orchestrator tests)
# ---------------------------------------------------------------------------
def test_normalize_steps_forms_and_errors_match_jax():
    steps = [{"despike": {"threshold": 5.0}}, {"step": "static", "mode": "amp"},
             {"delrt_pad": None},
             {"reproject": {"src-epsg": 4326, "dst-epsg": 32632}},
             {"tide": {"tide-file": "x.nc", "coords-bytes": [73, 77]}}]
    assert _normalize_steps(copy.deepcopy(steps)) == \
        jorch._normalize_steps(copy.deepcopy(steps))
    assert _normalize_steps(steps[:3]) == [("despike", {"threshold": 5.0}),
                                           ("static", {"mode": "amp"}),
                                           ("delrt-pad", {})]
    for bad, match in (([{"frobnicate": {}}], "unknown step"),
                       ([{"reproject": {"dst_epsg": 32632}}],
                        "reproject.*src_epsg"),
                       ([{"tide": {}}], "tide.*tide_file"),
                       ([{"tide": {"tide_file": None}}], "tide.*tide_file"),
                       (["despike"], "each step must be a mapping"),
                       ([{"a": {}, "b": {}}], "ambiguous step entry")):
        with pytest.raises(ValueError, match=match):
            _normalize_steps(bad)
        with pytest.raises(ValueError) as je:
            jorch._normalize_steps(bad)
        with pytest.raises(ValueError) as pe:
            _normalize_steps(bad)
        assert str(pe.value) == str(je.value)
    assert run_pipeline.__defaults__ == (1, False, None)


def _same_geometry(g, jg):
    for f in ("spacing", "extent", "rotation_angle", "rotation_center",
              "twt_limits", "stacking_method", "idw_power", "region_extent",
              "region_spacing", "crs"):
        assert getattr(g, f) == getattr(jg, f), f
    for f in ("corner_points", "region_corner_points"):
        a, b = getattr(g, f), getattr(jg, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_geometry_from_dict_matches_jax(tmp_path):
    y = tmp_path / "geom.yml"
    y.write_text(yaml.safe_dump({
        "bin_size": {"iline": 5.0, "xline": 5.0}, "extent": [0, 50, 0, 50],
        "rotation": {"angle": 30.0, "center": [1.0, 2.0]}}))
    crs = tmp_path / "crs.txt"
    crs.write_text("EPSG:32633\n")
    for g in ({"spacing": [10.0, 20.0], "extent": [0, 100, 0, 200],
               "stack": "median"},
              {"geometry_yaml": str(y)},
              {"geometry_yaml": str(y), "stack": "median", "spacing": 10.0,
               "twt_limits": [0.0, 2.0]},
              {"bin_size": 7.5, "corner_points": [[0, 0], [0, 10], [10, 10],
                                                  [10, 0]]},
              {"spacing": 10.0, "extent": [0, 10, 0, 10],
               "spatial_ref": f"@{crs}", "factor_dist": 2.0}):
        _same_geometry(geometry_from_dict(dict(g)),
                       jorch.geometry_from_dict(dict(g)))
    with pytest.raises(ValueError, match="spacing"):
        geometry_from_dict({"spacing": [10.0, 20.0, 30.0]})


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------
def test_without_a_card_run_pipeline_raises_before_any_step(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    survey = tmp_path / "survey"
    survey.mkdir()
    make_profile(str(survey / "a_UTM.sgy"), ntr=8, ns=32, seed=0)
    cfg = {"input": str(survey), "workdir": str(tmp_path / "w"),
           "steps": [{"merge": {}}, {"despike": {}}]}
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_pipeline(cfg, verbose=0)
    assert not (tmp_path / "w").exists()
    p = tmp_path / "p.yml"
    p.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["run", str(p), "-V", "0"])
    # host steps alone need no card
    cfg["steps"] = [{"merge": {}}]
    assert run_pipeline(cfg, verbose=0).endswith("01_merge.txt")


# ---------------------------------------------------------------------------
# examples/pipeline.yml at a small grid, in both packages
# ---------------------------------------------------------------------------
def _example_config(survey, tide, workdir):
    """``examples/pipeline.yml``'s steps on the survey of
    ``write_stage1_survey``: stage 1 with the options of
    ``torch_helpers.stage1_steps``, a 50 m grid over the survey's UTM
    extent, and a 4-iteration soft-threshold POCS (inline parameters)
    through the checkpointed driver."""
    with open(EXAMPLE) as fh:
        example = yaml.safe_load(fh)
    names = [next(iter(s)) for s in example["steps"]]
    steps = stage1_pipeline_steps(tide)
    assert [next(iter(s)) for s in steps] == names[:8]
    nav = navigation_table(str(survey))
    x, y = crs_transform(nav["x"], nav["y"], 4326, 32632)
    extent = [float(np.floor(x.min() / 50) * 50 - 50),
              float(np.ceil(x.max() / 50) * 50 + 50),
              float(np.floor(y.min() / 50) * 50 - 50),
              float(np.ceil(y.max() / 50) * 50 + 50)]
    stage2 = {
        "binning": {"spacing": 50.0, "extent": extent, "stack": "average"},
        "qc": {}, "preprocess": {"balance": "rms"}, "fft": {},
        "pocs": {"params": {"metadata": {
            "niter": 4, "thresh_op": "soft", "thresh_model": "exponential",
            "p_min": "adaptive", "version": "fast", "alpha": 0.75,
            "eps": 0.0, "precision": "highest"}},
            "checkpoint_dir": "ck", "batch": 16},
        "ifft": {}, "postprocess": {"agc_win": 0.05},
        "cube2segy": {"output": "final.sgy"}}
    steps += [{n: stage2[n]} for n in names[8:]]
    return {"input": str(survey), "workdir": str(workdir), "steps": steps}


def _tree(workdir):
    """Every file under ``workdir`` by relative path, with its mtime."""
    out = {}
    for root, _, files in os.walk(workdir):
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, workdir)] = os.stat(p).st_mtime_ns
    return out


@pytest.fixture(scope="module")
def example_runs(tmp_path_factory):
    """The example's workflow through ``p3d run`` and ``p3d-torch run``
    (``--device cpu``), each on its own copy of the survey; then each
    package's step-11 artifact and datalist 08 removed and the workflow run
    again with ``--resume``."""
    tmp = tmp_path_factory.mktemp("example")
    from pseudo_3d_interpolation_tpu import cli as jcli

    runs = {}
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("port", cli.main, ["--device", CPU])):
        survey = tmp / pkg / "survey"
        survey.mkdir(parents=True)
        truth = write_stage1_survey(survey)
        work = tmp / pkg / "work"
        cfg = _example_config(survey, truth["tide"], work)
        p = tmp / pkg / "pipeline.yml"
        p.write_text(yaml.safe_dump(cfg))
        assert main(["run", str(p), "-V", "0"] + extra) == 0
        first = _tree(work)
        os.remove(work / "11_preprocess.nc")
        os.remove(work / "08_despike.txt")
        assert main(["run", str(p), "--resume", "-V", "0"] + extra) == 0
        second = _tree(work)
        rerun = sorted(k for k, t in second.items() if first.get(k) != t)
        runs[pkg] = (work, first, rerun)
    return runs


def test_example_workflow_writes_the_artifacts_jax_writes(example_runs):
    (jwork, jfirst, _), (work, first, _) = example_runs["jax"], \
        example_runs["port"]
    names = {k for k in first if not k.endswith("_argparse_parameter.yml")}
    jnames = {k for k in jfirst if not k.endswith("_argparse_parameter.yml")}
    assert names == jnames
    for k in ("01_merge.txt", "08_despike.txt", "09_cube.nc",
              "11_preprocess.nc", "12_fft.nc", "13_pocs.nc", "14_ifft.nc",
              "15_postprocess.nc", "final.sgy"):
        assert k in names, k
    assert any(k.startswith("10_qc/") and k.endswith(".png") for k in names)
    assert any(k.startswith("ck/") for k in names)


def test_example_workflow_contents_match_jax(example_runs):
    (jwork, _, _), (work, _, _) = example_runs["jax"], example_runs["port"]
    # stage 1: every SEG-Y byte for byte, the sidecars as numbers
    for datalist in sorted(p.name for p in jwork.glob("0[1-8]_*.txt")):
        outs = open(work / datalist).read().split()
        jouts = open(jwork / datalist).read().split()
        assert [os.path.relpath(p, work) for p in outs] == \
            [os.path.relpath(p, jwork) for p in jouts]
        for p, jp in zip(outs, jouts):
            with open(p, "rb") as f, open(jp, "rb") as g:
                assert f.read() == g.read(), p
    sidecars = [p for suffix in (".sta", ".tid", ".mst")
                for p in sorted(jwork.glob(f"0[5-7]_*/*{suffix}"))]
    assert len(sidecars) == 12
    for sidecar in sidecars:
        rel = sidecar.relative_to(jwork)
        same_csv(str(work / rel), str(sidecar), atol={"tide_m": 1e-12})
    same_csv(str(work / "06_tide" / "misties.csv"),
             str(jwork / "06_tide" / "misties.csv"),
             atol={"correlation": 1e-6})
    # stage 2: the cubes
    for name, tol in (("09_cube.nc", 1e-6), ("11_preprocess.nc", 1e-5),
                      ("12_fft.nc", 1e-5), ("13_pocs.nc", CHAIN_TOL),
                      ("14_ifft.nc", CHAIN_TOL),
                      ("15_postprocess.nc", CHAIN_TOL)):
        c, jc = read_cube(str(work / name)), jread_cube(str(jwork / name))
        assert sorted(c.data_vars) == sorted(jc.data_vars), name
        for var in jc.data_vars:
            _close(c.data_vars[var][1], jc.data_vars[var][1], tol)
        assert c.attrs.get("history") == jc.attrs.get("history"), name
    with SegyFile(str(work / "final.sgy")) as f, \
            SegyFile(str(jwork / "final.sgy")) as g:
        assert f.text_raw == g.text_raw
        np.testing.assert_array_equal(f.trace_headers_raw(),
                                      g.trace_headers_raw())
        _close(f.trace_data(), g.trace_data(), CHAIN_TOL)
        assert np.isfinite(f.trace_data()).all()


def test_example_workflow_resume_skips_the_steps_jax_skips(example_runs):
    (_, _, jrerun), (_, _, rerun) = example_runs["jax"], example_runs["port"]
    assert rerun == jrerun
    assert "08_despike.txt" in rerun and "11_preprocess.nc" in rerun
    assert "09_cube.nc" not in rerun and "01_merge.txt" not in rerun


# ---------------------------------------------------------------------------
# the JAX package's orchestrator tests, on the port
# ---------------------------------------------------------------------------
def test_run_via_cli(tmp_path):
    survey = tmp_path / "survey"
    survey.mkdir()
    make_profile(str(survey / "a_UTM.sgy"), ntr=8, ns=32, seed=0)
    cfg = {"input": str(survey), "workdir": str(tmp_path / "w"),
           "steps": [{"despike": {}}]}
    p = tmp_path / "p.yml"
    p.write_text(yaml.safe_dump(cfg))
    assert cli.main(["run", str(p), "-V", "0", "--device", CPU]) == 0
    assert (tmp_path / "w" / "01_despike.txt").exists()


def test_run_pipeline_resume(tmp_path):
    survey = tmp_path / "survey"
    survey.mkdir()
    make_profile(str(survey / "a_UTM.sgy"), ntr=24, ns=64, seed=0)
    cfg = {"input": str(survey), "workdir": str(tmp_path / "w"),
           "steps": [{"despike": {}}, {"static": {"savgol_window": 11}}]}
    run_pipeline(cfg, verbose=0, device=CPU)
    lst = tmp_path / "w" / "01_despike.txt"
    t0 = os.path.getmtime(lst)
    os.remove(tmp_path / "w" / "02_static.txt")
    run_pipeline(cfg, verbose=0, resume=True, device=CPU)
    assert os.path.getmtime(lst) == t0
    assert (tmp_path / "w" / "02_static.txt").exists()


def test_relative_workdir_chaining(tmp_path, monkeypatch):
    """Datalists chain across steps when workdir is relative (the lines
    are written absolute)."""
    survey = tmp_path / "survey"
    survey.mkdir()
    make_profile(str(survey / "a_UTM.sgy"), ntr=24, ns=64, seed=0)
    monkeypatch.chdir(tmp_path)
    cfg = {"input": str(survey), "workdir": "out",
           "steps": [{"despike": {}}, {"static": {"savgol_window": 11}}]}
    run_pipeline(cfg, verbose=0, device=CPU)
    assert (tmp_path / "out" / "02_static.txt").exists()


def _line_survey(d, n=3, ns=16):
    d.mkdir()
    for i in range(n):
        make_profile(str(d / f"l{i}_UTM.sgy"), ntr=24, ns=ns, seed=i,
                     x0=5.0 + i * 10.0, y0=5.0, heading=(0, 1), spacing=10.0,
                     times_start=f"2023-05-01T{10 + i:02d}:00:00")


def test_qc_and_checkpointed_pocs_steps(tmp_path):
    _line_survey(tmp_path / "survey", n=4, ns=64)
    cfg = {"input": str(tmp_path / "survey"),
           "workdir": str(tmp_path / "w"),
           "steps": [
               {"binning": {"spacing": 10.0, "extent": [0, 40, 0, 240]}},
               {"qc": {}}, {"fft": {}},
               {"pocs": {"checkpoint_dir": "ck", "batch": 8,
                         "params": {"metadata": {
                             "transform_kind": "FFT", "version": "fast",
                             "niter": 6, "eps": 0.0, "thresh_op": "hard",
                             "thresh_model": "exponential",
                             "p_min": 1e-3}}}},
               {"ifft": {}}]}
    final = run_pipeline(cfg, verbose=0, device=CPU)
    assert final.endswith("05_ifft.nc") and os.path.exists(final)
    assert any(p.suffix == ".png" for p in (tmp_path / "w" / "02_qc").iterdir())
    assert any((tmp_path / "w" / "ck").iterdir())


def test_checkpointed_pocs_default_params_and_cube2segy_name(tmp_path):
    """pocs with checkpoint_dir but no params takes the standard default;
    a cube2segy output name without .sgy is honored."""
    _line_survey(tmp_path / "survey")
    cfg = {"input": str(tmp_path / "survey"),
           "workdir": str(tmp_path / "w"),
           "steps": [
               {"binning": {"spacing": 10.0, "extent": [0, 30, 0, 240]}},
               {"fft": {}}, {"pocs": {"checkpoint_dir": "ck", "batch": 8}},
               {"ifft": {}}, {"cube2segy": {"output": "final_cube"}}]}
    final = run_pipeline(cfg, verbose=0, device=CPU)
    assert final == str(tmp_path / "w" / "final_cube")
    assert os.path.exists(final)
    assert os.path.exists(tmp_path / "w" / "03_pocs.nc")


def test_dash_spelled_step_runs_end_to_end(tmp_path):
    survey = tmp_path / "survey"
    survey.mkdir()
    make_profile(str(survey / "a_UTM.sgy"), ntr=6, ns=32, seed=1,
                 x0=500000.0, y0=6000000.0, heading=(0, 1), spacing=5.0)
    cfg = {"input": str(survey), "workdir": str(tmp_path / "work"),
           "steps": [{"reproject": {"src-epsg": 32632, "dst-epsg": 4326}}]}
    assert run_pipeline(cfg)


def test_binning_step_accepts_crs_and_factor_dist(tmp_path):
    survey = tmp_path / "survey"
    survey.mkdir()
    make_profile(str(survey / "a_UTM.sgy"), ntr=8, ns=32, seed=1,
                 x0=10.0, y0=4.0, heading=(0, 1), spacing=5.0)
    cfg = {"input": str(survey), "workdir": str(tmp_path / "wk"),
           "steps": [{"binning": {
               "spacing": 20.0, "extent": [0, 20, 0, 40], "stack": "idw",
               "factor_dist": 2.0, "spatial_ref": "EPSG:32633"}}]}
    cube = read_cube(run_pipeline(cfg, device=CPU))
    assert cube.attrs["epsg"] == 32633
    assert cube.attrs["stacking_method"] == "idw"
