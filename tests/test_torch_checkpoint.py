"""The port's checkpointed interpolation, ``warmup``, the scanned solver
and the resident driver's ``_max_launches`` against the JAX package's
(JAX tests/test_pipeline_3d.py:138-235, tests/test_parallel.py:116), on
the CPU.

Tolerance, against ``max|JAX|``: ``TOL`` = 2.5e-6 with a soft threshold
(float32 FFTs against the JAX matmul DFTs over 6 iterations, about twenty
float32 roundings); between the port's own drivers the slices go through
the same code, so they are held bit-equal."""

import csv
import importlib
import json
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.io.ncio import read_cube as jread_cube
from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops.cplx import from_complex as jfrom_complex
from pseudo_3d_interpolation_tpu.parallel import solver as jsolver
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.io.ncio import read_cube, write_cube
from pseudo_3d_interpolation_torch.models.pocs import POCSConfig
from pseudo_3d_interpolation_torch.models.transforms import get_transform
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.parallel import solver
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe

jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

TOL = 2.5e-6
H, W, F = 32, 40, 40
BATCH = 16  # 40 slices: batches 0-16, 16-32 and a short tail 32-40
SOFT = dict(niter=6, p_min=1e-3, version="fast", alpha=0.75,
            thresh_op="soft")
CPU = "cpu"


def _freq(seed=0, f=F, h=H, w=W):
    """(iline, xline, freq) complex64 observations of a few plane waves a
    slice, with the fold of the kept traces, and the coords."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((h, w, f), np.complex64)
    for i in range(f):
        for _ in range(3):
            fy, fx = rng.integers(1, 6, size=2)
            truth[..., i] += np.exp(2j * np.pi * (fy * yy / h + fx * xx / w)
                                    + 1j * rng.uniform(0, 2 * np.pi))
    fold = np.broadcast_to((rng.uniform(size=w) < 0.5)[None, :],
                           (h, w)).astype(np.int32)
    coords = {"iline": np.arange(h), "xline": np.arange(w),
              "freq_twt": np.arange(f, dtype=np.float64) * 2.0}
    return truth * fold[..., None], fold, coords


def _cube(cls, amp, fold, coords):
    return cls(coords={k: v.copy() for k, v in coords.items()},
               data_vars={"freq_amp": (("iline", "xline", "freq_twt"), amp),
                          "fold": (("iline", "xline"), fold)},
               attrs={"history": "BIN;FFT;", "text": "\nmade"},
               var_attrs={"freq_amp": {"units": "a.u."}})


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _slice_files(d):
    return sorted(f for f in os.listdir(d) if f.startswith("slices_"))


def test_checkpointed_matches_jax_and_resumes_without_solving(tmp_path):
    amp, fold, coords = _freq()
    cfg = POCSConfig(**SOFT)
    jout = jpipe.interpolate_checkpointed(
        _cube(JCube, amp, fold, coords), jpocs.POCSConfig(**SOFT),
        str(tmp_path / "jck"), batch=BATCH)
    out = pipe.interpolate_checkpointed(_cube(Cube, amp, fold, coords), cfg,
                                        str(tmp_path / "ck"), batch=BATCH,
                                        device=CPU)
    got = out["freq_amp_interp"]
    assert got.shape == (H, W, F)
    assert _max_rel(got, np.asarray(jout["freq_amp_interp"])) <= TOL
    assert _slice_files(tmp_path / "ck") == _slice_files(tmp_path / "jck") \
        == ["slices_00000_00016.nc", "slices_00016_00032.nc",
            "slices_00032_00040.nc"]
    assert os.path.exists(tmp_path / "ck" / "checkpoint_meta.json")
    assert out.attrs["history"] == jout.attrs["history"] == \
        "BIN;FFT;POCS(FFT,fast,checkpointed);"
    assert out.attrs["text"] == jout.attrs["text"]
    assert out.attrs["pocs_mean_iterations"] == \
        jout.attrs["pocs_mean_iterations"] == 6.0
    assert out.var_attrs["freq_amp_interp"] == {"units": "a.u."}
    # the same solve as interpolate's, batch for batch
    whole = pipe.interpolate(_cube(Cube, amp, fold, coords), cfg,
                             batch=BATCH, device=CPU)
    np.testing.assert_array_equal(got, whole["freq_amp_interp"])

    def boom(*a, **k):
        raise AssertionError("resume recomputed a batch despite checkpoints")
    with mock.patch.object(solver, "interpolate_cube", boom):
        # negative control: with a checkpoint missing the spy must fire
        victim = tmp_path / "ck" / "slices_00016_00032.nc"
        os.rename(victim, str(victim) + ".bak")
        with pytest.raises(AssertionError, match="recomputed"):
            pipe.interpolate_checkpointed(_cube(Cube, amp, fold, coords),
                                          cfg, str(tmp_path / "ck"),
                                          batch=BATCH, device=CPU)
        os.rename(str(victim) + ".bak", victim)
        again = pipe.interpolate_checkpointed(
            _cube(Cube, amp, fold, coords), cfg, str(tmp_path / "ck"),
            batch=BATCH, device=CPU)
    np.testing.assert_array_equal(again["freq_amp_interp"], got)


def test_checkpoint_dir_refuses_a_different_run(tmp_path):
    amp, fold, coords = _freq(seed=1)
    ck = str(tmp_path / "ck")
    pipe.interpolate_checkpointed(_cube(Cube, amp, fold, coords),
                                  POCSConfig(niter=4, p_min=1e-3), ck,
                                  batch=BATCH, device=CPU)
    with pytest.raises(ValueError, match="different run"):
        pipe.interpolate_checkpointed(_cube(Cube, amp, fold, coords),
                                      POCSConfig(niter=6, p_min=1e-3), ck,
                                      batch=BATCH, device=CPU)
    with pytest.raises(ValueError, match="different run"):
        pipe.interpolate_checkpointed(
            _cube(Cube, amp, fold, coords),
            {"metadata": {"niter": 4, "p_min": 1e-3, "precision": "highest"}},
            ck, batch=BATCH, device=CPU)
    # the unchanged run resumes
    pipe.interpolate_checkpointed(_cube(Cube, amp, fold, coords),
                                  POCSConfig(niter=4, p_min=1e-3), ck,
                                  batch=BATCH, device=CPU)
    # a directory the JAX package wrote carries its TPU-only fields in the
    # fingerprint: refused, not merged
    jck = str(tmp_path / "jck")
    jpipe.interpolate_checkpointed(_cube(JCube, amp, fold, coords),
                                   jpocs.POCSConfig(niter=4, p_min=1e-3),
                                   jck, batch=BATCH)
    with open(os.path.join(jck, "checkpoint_meta.json")) as fh:
        assert "use_pallas" in json.load(fh)["config"]
    with pytest.raises(ValueError, match="different run"):
        pipe.interpolate_checkpointed(_cube(Cube, amp, fold, coords),
                                      POCSConfig(niter=4, p_min=1e-3), jck,
                                      batch=BATCH, device=CPU)


def test_tail_slab_is_padded_to_the_batch_and_cut_back(tmp_path):
    amp, fold, coords = _freq(seed=2)
    shapes = []
    real = solver.interpolate_cube

    def spy(moved, *a, **k):
        shapes.append(moved.shape[0])
        return real(moved, *a, **k)
    with mock.patch.object(solver, "interpolate_cube", spy):
        out = pipe.interpolate_checkpointed(
            _cube(Cube, amp, fold, coords), POCSConfig(niter=4, p_min=1e-3),
            str(tmp_path / "ck"), batch=BATCH, device=CPU)
    assert shapes == [BATCH] * 3
    assert out["freq_amp_interp"].shape[-1] == F
    tail = read_cube(tmp_path / "ck" / "slices_00032_00040.nc")
    assert tail["rec"].shape == (8, H, W) and tail["cost"].shape == (8,)


def test_path_input_streams_into_the_same_file_as_jax(tmp_path):
    amp, fold, coords = _freq(seed=3)
    src = str(tmp_path / "freq.nc")
    write_cube(src, _cube(Cube, amp, fold, coords),
               chunks={"freq_twt": 1})
    with pytest.raises(ValueError, match="requires out_path"):
        pipe.interpolate_checkpointed(src, POCSConfig(**SOFT),
                                      str(tmp_path / "ck0"), device=CPU)
    jout = jpipe.interpolate_checkpointed(
        src, jpocs.POCSConfig(**SOFT), str(tmp_path / "jck"), batch=BATCH,
        out_path=str(tmp_path / "jout.nc"),
        runtime_csv=str(tmp_path / "jrt.csv"))
    out = pipe.interpolate_checkpointed(
        src, POCSConfig(**SOFT), str(tmp_path / "ck"), batch=BATCH,
        out_path=str(tmp_path / "out.nc"),
        runtime_csv=str(tmp_path / "rt.csv"), device=CPU)
    assert out == str(tmp_path / "out.nc") and jout == str(
        tmp_path / "jout.nc")
    mine, theirs = jread_cube(out), read_cube(jout)  # each package's reader
    assert set(mine.data_vars) == set(theirs.data_vars) == {
        "freq_amp_interp", "fold"}
    assert mine.data_vars["freq_amp_interp"][0] == ("iline", "xline",
                                                    "freq_twt")
    assert _max_rel(np.asarray(mine["freq_amp_interp"]),
                    theirs["freq_amp_interp"]) <= TOL
    np.testing.assert_array_equal(np.asarray(mine["fold"]), fold)
    for k in ("iline", "xline", "freq_twt"):
        np.testing.assert_array_equal(np.asarray(mine.coords[k]),
                                      theirs.coords[k])
    assert mine.attrs["history"] == theirs.attrs["history"]
    assert mine.attrs["pocs_mean_iterations"] == \
        theirs.attrs["pocs_mean_iterations"]
    # the streamed file holds what the in-memory path returns
    ram = pipe.interpolate_checkpointed(_cube(Cube, amp, fold, coords),
                                        POCSConfig(**SOFT),
                                        str(tmp_path / "ck"), batch=BATCH,
                                        device=CPU)
    np.testing.assert_array_equal(read_cube(out)["freq_amp_interp"],
                                  ram["freq_amp_interp"])
    with open(tmp_path / "rt.csv") as a, open(tmp_path / "jrt.csv") as b:
        rows, jrows = list(csv.reader(a)), list(csv.reader(b))
    assert rows[0] == jrows[0] == ["freq_twt", "niterations", "cost"]
    got = np.array(rows[1:], np.float64)
    want = np.array(jrows[1:], np.float64)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("kind", ["FFT", "SHEARLET"])
def test_scanned_solver_matches_the_batched_driver_and_jax(kind):
    """JAX tests/test_parallel.py:116: the whole cube solved in one
    program equals the per-batch dispatch."""
    rng = np.random.default_rng(3)
    f, n = 16, 64
    truth = (rng.normal(size=(f, n, n))
             + 1j * rng.normal(size=(f, n, n))).astype(np.complex64)
    mask = np.ascontiguousarray(np.broadcast_to(
        (rng.uniform(size=n) < 0.5).astype(np.float32)[None, :], (n, n)))
    obs = truth * mask
    kw = dict(SOFT, transform_kind=kind)
    cfg = POCSConfig(**kw)
    tr = get_transform(kind)
    rec_b, ni_b, cost_b = solver.interpolate_cube(obs, mask, cfg,
                                                  transform=tr, batch=8,
                                                  device=CPU)
    z = Cplx(torch.from_numpy(obs.real.copy()),
             torch.from_numpy(obs.imag.copy()))
    rec_s, ni_s, cost_s = solver.pocs_interpolate_scanned(z, mask, tr, cfg,
                                                          batch=8)
    assert isinstance(rec_s.re, torch.Tensor) and rec_s.re.shape == (f, n, n)
    np.testing.assert_array_equal(rec_s.re.numpy() + 1j * rec_s.im.numpy(),
                                  rec_b)
    np.testing.assert_array_equal(ni_s.numpy(), ni_b)
    np.testing.assert_array_equal(cost_s.numpy(), cost_b)
    jz = jfrom_complex(obs)
    jrec, jni, _ = jsolver.pocs_interpolate_scanned(
        jz, mask, jget(kind), jpocs.POCSConfig(**kw), batch=8)
    want = np.asarray(jrec.re) + 1j * np.asarray(jrec.im)
    assert _max_rel(rec_s.re.numpy() + 1j * rec_s.im.numpy(), want) <= (
        TOL if kind == "FFT" else 5e-6)
    np.testing.assert_array_equal(ni_s.numpy(), np.asarray(jni))
    with pytest.raises(ValueError, match="not divisible by batch"):
        solver.pocs_interpolate_scanned(Cplx(z.re[:12], z.im[:12]), mask,
                                        tr, cfg, batch=8)


def test_resident_max_launches_solves_only_the_first_batches():
    amp, fold, _ = _freq(seed=4)
    data = np.moveaxis(amp, -1, 0)
    mask = fold.astype(np.float32)
    cfg = POCSConfig(**SOFT)
    full = solver.interpolate_cube_resident(data, mask, cfg, batch=BATCH,
                                            device=CPU)
    calls = []
    real = solver.pocs_interpolate

    def spy(z, *a, **k):
        calls.append(z.shape[0])
        return real(z, *a, **k)
    with mock.patch.object(solver, "pocs_interpolate", spy):
        one = solver.interpolate_cube_resident(data, mask, cfg, batch=BATCH,
                                               device=CPU, _max_launches=1)
    assert calls == [BATCH]
    np.testing.assert_array_equal(one[0][:BATCH], full[0][:BATCH])
    np.testing.assert_array_equal(one[1][:BATCH], full[1][:BATCH])


@pytest.mark.parametrize("resident", [True, False])
def test_warmup_runs_one_launch_of_the_driver_interpolate_takes(
        monkeypatch, resident):
    calls = []
    real = solver.pocs_interpolate

    def spy(z, *a, **k):
        calls.append(tuple(z.shape))
        return real(z, *a, **k)
    monkeypatch.setattr(solver, "pocs_interpolate", spy)
    monkeypatch.setattr(pipe, "fits_resident", lambda *a, **k: resident)
    cfg = POCSConfig(**SOFT, pad_to_tile=True)
    wall = pipe.warmup(cfg, (100, 120), batch=64, n_slices=70, device=CPU)
    assert isinstance(wall, float) and wall > 0
    # the resident driver: one batch of min(batch, 32) slices of a
    # 70-slice cube; the host-chunked one: one batch of min(batch, 70);
    # both padded to 128x128
    assert calls == [(32, 128, 128) if resident else (64, 128, 128)]
    calls.clear()
    pipe.warmup({"metadata": dict(SOFT)}, (48, 40), batch=8, device=CPU)
    assert calls == [(8, 48, 40)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pipe.warmup(cfg, (32, 32))


def test_interpolate_checkpointed_yaml_and_dataclass_configs_agree(tmp_path):
    amp, fold, coords = _freq(seed=5, f=20)
    meta = dict(SOFT, transform_kind="DCT")
    a = pipe.interpolate_checkpointed(_cube(Cube, amp, fold, coords),
                                      {"metadata": meta},
                                      str(tmp_path / "a"), batch=BATCH,
                                      device=CPU)
    b = pipe.interpolate_checkpointed(_cube(Cube, amp, fold, coords),
                                      POCSConfig(**meta),
                                      str(tmp_path / "b"), batch=BATCH,
                                      device=CPU)
    np.testing.assert_array_equal(a["freq_amp_interp"], b["freq_amp_interp"])
    with open(tmp_path / "a" / "checkpoint_meta.json") as fh:
        fp = json.load(fh)
    assert fp["transform_kwargs"] == {"precision": "high"}
    assert fp["slice_shape"] == [H, W] and fp["f_total"] == 20
    assert fp["config"]["pad_to_tile"] is None
