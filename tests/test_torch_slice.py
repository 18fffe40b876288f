"""Slice 1 as a whole: the port's ``pipeline.pocs.interpolate`` (FFT basis,
FPOCS, production defaults) against the JAX package's on the same cube,
plus the solver route table, the zero-slice short-circuit, the carry-over
of the JAX configuration (compat) and import hygiene. The JAX side runs its
fused Pallas solve in interpret mode on the CPU (use_pallas and
pallas_interpret), on a one-device mesh."""

import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_3d_interpolation_tpu.io.ncio import Cube as JCube
from pseudo_3d_interpolation_tpu.models.transforms import get_transform as jget
from pseudo_3d_interpolation_tpu.ops.cplx import Cplx as JCplx
from pseudo_3d_interpolation_tpu.parallel.mesh import make_mesh
from pseudo_3d_interpolation_tpu.pipeline import pocs as jpipe
from pseudo_3d_interpolation_torch import compat
from pseudo_3d_interpolation_torch.io.cube import Cube
from pseudo_3d_interpolation_torch.models import pocs
from pseudo_3d_interpolation_torch.models.transforms import (FFTTransform,
                                                             get_transform)
from pseudo_3d_interpolation_torch.ops.cplx import Cplx
from pseudo_3d_interpolation_torch.parallel import solver
from pseudo_3d_interpolation_torch.pipeline import pocs as pipe

# the JAX models package re-exports a function named ``pocs`` over its
# submodule, so the module is taken from the import system
jpocs = importlib.import_module("pseudo_3d_interpolation_tpu.models.pocs")

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
H = W = 256
F = 4
NITER = 6
# the production stage-2 configuration (pipeline/pocs.py:377-388), cut to
# NITER iterations; the TPU-only keys steer the JAX side onto its fused
# kernel in interpret mode and are ignored by the port
META = dict(niter=NITER, thresh_op="hard", thresh_model="exponential",
            p_min="adaptive", version="fast", alpha=0.75, eps=0.0,
            use_pallas=True, pallas_interpret=True)
# 'highest' is full fp32 on both sides (JAX: fp32 matmul DFTs with the
# radix split; port: torch.fft): measured 1.5e-6·max|ref| at this size
TIGHT_TOL = 2e-5
# 'high' is a hand-made bf16x3 on the JAX side and fp32 here, and the
# hard threshold flips boundary coefficients: compared by SNR
SNR_TOL_DB = 0.1


def _truth(f=F, h=H, w=W):
    yy, xx = np.mgrid[0:h, 0:w]
    truth = np.zeros((f, h, w), np.complex64)
    for i in range(f):
        r = np.random.default_rng(i)
        for _ in range(6):
            fy, fx = r.integers(1, 24, size=2)
            truth[i] += r.uniform(0.5, 2.0) * np.exp(
                2j * np.pi * (fy * yy / h + fx * xx / w)
                + 1j * r.uniform(0, 6.28))
    cols = np.random.default_rng(100).uniform(size=w) < 0.5
    mask = np.ascontiguousarray(np.broadcast_to(cols[None, :], (h, w)),
                                np.float32)
    return truth, mask


def _cubes(obs, mask):
    """The same (iline, xline, freq) cube for both packages."""
    f = obs.shape[0]
    coords = {"iline": np.arange(obs.shape[1]),
              "xline": np.arange(obs.shape[2]),
              "freq": np.arange(f, dtype=np.float64)}
    data_vars = {"amp": (("iline", "xline", "freq"),
                         np.ascontiguousarray(np.moveaxis(obs, 0, -1))),
                 "fold": (("iline", "xline"), mask.astype(np.int32))}
    return (JCube(coords=dict(coords), data_vars=dict(data_vars)),
            Cube(coords=dict(coords), data_vars=dict(data_vars)))


def _rec(cube):
    return np.moveaxis(np.asarray(cube.data_vars["amp_interp"][1]), -1, 0)


def _snr(ref, x):
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / np.sum(np.abs(ref - x) ** 2))


def _run_both(config, obs, mask, **kw):
    jcube, cube = _cubes(obs, mask)
    jout = jpipe.interpolate(jcube, config=config, mesh=make_mesh(1), **kw)
    out = pipe.interpolate(cube, config=config, device="cpu")
    return _rec(jout), _rec(out), jout, out


def test_interpolate_matches_jax_at_highest():
    truth, mask = _truth()
    obs = truth * mask
    ref, got, jout, out = _run_both(
        {"metadata": dict(META, precision="highest")}, obs, mask)
    assert got.dtype == np.complex64 and got.shape == obs.shape
    assert np.abs(got - ref).max() <= TIGHT_TOL * np.abs(ref).max()
    assert _snr(truth, got) > _snr(truth, obs) + 3.0
    np.testing.assert_allclose(out.attrs["pocs_mean_cost"],
                               jout.attrs["pocs_mean_cost"], rtol=1e-3)
    assert out.attrs["pocs_mean_iterations"] == NITER
    assert out.attrs["history"] == jout.attrs["history"]


def test_interpolate_matches_jax_at_production_precision(tmp_path):
    """The production default 'high' (no precision key), with the
    per-slice runtime CSV both packages write."""
    truth, mask = _truth()
    obs = truth * mask
    jcube, cube = _cubes(obs, mask)
    jcsv, csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    jout = jpipe.interpolate(jcube, config=jpocs.POCSConfig(**META),
                             mesh=make_mesh(1), runtime_csv=str(jcsv))
    out = pipe.interpolate(cube, config={"metadata": META}, device="cpu",
                           runtime_csv=str(csv))
    ref, got = _rec(jout), _rec(out)
    assert abs(_snr(truth, got) - _snr(truth, ref)) < SNR_TOL_DB
    jrows = [r.split(",") for r in jcsv.read_text().split()]
    rows = [r.split(",") for r in csv.read_text().split()]
    assert rows[0] == jrows[0] == ["freq", "niterations", "cost"]
    for r, jr in zip(rows[1:], jrows[1:], strict=True):
        assert float(r[0]) == float(jr[0]) and int(r[1]) == int(jr[1])
        np.testing.assert_allclose(float(r[2]), float(jr[2]), rtol=1e-2)


def test_zero_slice_short_circuits_like_jax():
    truth, mask = _truth(f=3, h=128, w=128)
    obs = truth * mask
    obs[1] = 0
    cfg = dict(META, precision="highest")
    jcfg = jpocs.POCSConfig(**{k: v for k, v in cfg.items()
                               if k != "precision"})
    jres = jpocs.pocs_interpolate(JCplx(jnp.asarray(obs.real),
                                        jnp.asarray(obs.imag)),
                                  jnp.asarray(mask), jget("FFT"), jcfg)
    res = pocs.pocs_interpolate(
        Cplx(torch.from_numpy(obs.real.copy()),
             torch.from_numpy(obs.imag.copy())),
        torch.from_numpy(mask), FFTTransform(),
        compat.config_from_reference(dataclasses.asdict(jcfg)))
    assert res.n_iterations.tolist() == [NITER, 0, NITER]
    assert res.n_iterations.tolist() == np.asarray(jres.n_iterations).tolist()
    assert res.cost[1] == 0 and np.asarray(jres.cost)[1] == 0
    assert not res.data.re[1].any() and not res.data.im[1].any()
    np.testing.assert_allclose(res.cost.numpy(), np.asarray(jres.cost),
                               rtol=1e-3)


# each configuration outside the slice, with the route the JAX package
# gives it
UNPORTED = [
    pytest.param({"eps": 1e-3}, id="eps"),
    pytest.param({"keep_cost_history": True}, id="history"),
    pytest.param({"global_early_stop": True}, id="global-early-stop"),
    pytest.param({"version": "adaptive"}, id="adaptive"),
    pytest.param({"thresh_op": "soft-percentile"}, id="percentile"),
]


def _jax_cfg(**change):
    return jpocs.POCSConfig(**dict(META, **change))


def test_describe_route_of_the_slice_matches_jax():
    jcfg = _jax_cfg()
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    shape, mshape = (32, 512, 512), (512, 512)
    jrt = jpocs.solver_route(shape, mshape, jcfg, jget("FFT"))
    rt = pocs.solver_route(shape, mshape, cfg, get_transform("FFT"))
    assert tuple(rt) == tuple(jrt) == ("fused-folded", "fft", "")
    assert pocs.describe_route(rt) == jpocs.describe_route(jrt) \
        == "fused-folded[fft]"
    # the kernel takes any shape: no %128 gate (JAX reads 384x500 as a
    # fallback; its first reason is the tile gate)
    assert pocs.solver_route((4, 384, 500), (384, 500), cfg).route \
        == "fused-folded"


@pytest.mark.parametrize("change", UNPORTED)
def test_unported_routes_match_jax_and_raise(change):
    jcfg = _jax_cfg(**change)
    cfg = compat.config_from_reference(dataclasses.asdict(jcfg))
    shape, mshape = (2, 128, 128), (128, 128)
    jrt = jpocs.solver_route(shape, mshape, jcfg, jget("FFT"))
    rt = pocs.solver_route(shape, mshape, cfg, get_transform("FFT"))
    assert tuple(rt) == tuple(jrt) and rt.reason
    assert pocs.describe_route(rt) == \
        f"{rt.route}[fft] — not ported: {jrt.reason}"
    z = Cplx(torch.ones(shape), torch.zeros(shape))
    with pytest.raises(NotImplementedError, match="not ported"):
        pocs.pocs_interpolate(z, torch.ones(mshape), config=cfg)


def test_unported_mask_and_basis_raise():
    cfg = compat.config_from_reference(dataclasses.asdict(_jax_cfg()))
    shape = (2, 64, 64)
    jrt = jpocs.solver_route(shape, shape, _jax_cfg(), jget("FFT"))
    rt = pocs.solver_route(shape, shape, cfg)
    assert tuple(rt) == tuple(jrt)
    z = Cplx(torch.ones(shape), torch.zeros(shape))
    with pytest.raises(NotImplementedError, match="exact 2-D"):
        pocs.pocs_interpolate(z, torch.ones(shape), config=cfg)
    for kind in ("DCT", "WAVELET", "SHEARLET", "CURVELET"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue"):
            pocs.pocs_interpolate(z, torch.ones(shape[1:]), config=
                                  dataclasses.replace(cfg,
                                                      transform_kind=kind))
    with pytest.raises(ValueError, match="Unsupported transform"):
        get_transform("FOURIER")
    with pytest.raises(TypeError, match="unknown transform option"):
        get_transform("FFT", precison="high")


def test_compat_carries_the_jax_configuration_over():
    jcfg = jpocs.POCSConfig(niter=np.int64(7), alpha=np.float32(0.5),
                            p_min="adaptive", version="fast",
                            use_pallas=True, pad_to_tile=False)
    d = dataclasses.asdict(jcfg)
    cfg = compat.config_from_reference(d)
    assert isinstance(cfg.niter, int) and isinstance(cfg.alpha, float)
    mine = dataclasses.asdict(cfg)
    for key in pocs.TPU_ONLY_FIELDS:
        assert key in d and key not in mine
        d.pop(key)
    assert mine == d
    assert compat.config_from_reference(mine) == cfg
    with pytest.raises(TypeError, match="no field"):
        compat.config_from_reference(dict(mine, new_knob=1))
    assert compat.transform_from_reference("FFT", {"precision": "high"}) \
        == FFTTransform(precision="high")
    assert compat.transform_from_reference("fft") == FFTTransform()
    with pytest.raises(NotImplementedError):
        compat.transform_from_reference("DCT")


def test_config_from_yaml_matches_jax(tmp_path):
    path = tmp_path / "pocs.yml"
    path.write_text(
        "metadata:\n  niter: 9\n  thresh_op: soft\n  p_min: adaptive\n"
        "  version: fast\n  precision: highest\n  use_pallas: true\n"
        "  n_workers: 4\n")
    jcfg, jextra = jpipe.config_from_yaml(str(path))
    cfg, extra = pipe.config_from_yaml(str(path))
    assert cfg == compat.config_from_reference(dataclasses.asdict(jcfg))
    assert extra == jextra == {"precision": "highest", "n_workers": 4}
    assert pipe._production_transform(cfg, extra) == \
        FFTTransform(precision="highest")
    assert pipe._production_transform(cfg, {}) == \
        FFTTransform(precision="high")
    with pytest.raises(ValueError, match="unrecognized"):
        pipe.config_from_yaml({"metadata": {"nitre": 3}})


def test_cube_drivers_agree_and_handle_edges():
    truth, mask = _truth(f=5, h=64, w=96)
    obs = truth * mask
    cfg = pocs.POCSConfig(**{k: v for k, v in META.items()
                             if k not in pocs.TPU_ONLY_FIELDS})
    a = solver.interpolate_cube_resident(obs, mask, cfg, batch=2,
                                         device="cpu")
    b = solver.interpolate_cube(obs, mask, cfg, batch=3, device="cpu")
    np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[2], b[2], rtol=1e-5)
    real = solver.interpolate_cube(obs.real.copy(), mask, cfg, device="cpu")
    assert real[0].dtype == np.float32
    empty = solver.interpolate_cube_resident(obs[:0], mask, cfg)
    assert empty[0].shape == (0, 64, 96) and empty[1].shape == (0,)
    # the host already holds the cube: the CPU always takes the resident
    # driver
    assert solver.fits_resident("cpu", 10**6, 32, 512, 512)
    with pytest.raises(NotImplementedError, match="netCDF"):
        pipe.interpolate("cube.nc")


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax (the
    machine with the card has none)."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import pseudo_3d_interpolation_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(k.startswith('pseudo_3d_interpolation_tpu') "
        "for k in sys.modules)\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
